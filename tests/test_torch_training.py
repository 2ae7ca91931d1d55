"""The port's classifier training against the JAX reference, on the CPU.

``AdamW``, ``global_norm`` and ``cosine_schedule`` on the same numpy
params and grads; ``train_batches`` byte for byte; and
``train_classifier`` from the reference's init (carried across by
``distilbert_from_numpy``) on the same batches, after 10 steps and after
the launcher's 150.

Budgets (f32, other sum orders in the products and their gradients):
the optimizer within 1e-6 relative; trained leaves within 1e-4 and
logits within 1e-4 (measured on an Intel Xeon CPU, PyTorch 2.13 against
JAX 0.9: 3.0e-5 for the leaves and 2.5e-5 for the logits after 150
steps).  The key biases
``layers/*/mix/bk`` are set apart: a constant added to every score of a
query leaves its softmax unchanged, so their true gradient is zero and
Adam turns the rounding noise in it into steps of the learning rate's
size (9.4e-4 after 150 steps) that move no logit.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import distilbert as jdb  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import ClassificationData as JData  # noqa: E402
from repro.training import cosine_schedule as jcosine  # noqa: E402
from repro.training import global_norm as jglobal_norm  # noqa: E402
from repro.training import make_classifier_train_step  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.training import (AdamW, ClassificationData,  # noqa: E402
                                  cosine_schedule, global_norm,
                                  train_classifier)

OPT_RTOL = 1e-6
LEAF_TOL = 1e-4
LOGIT_TOL = 1e-4
SMALL = dict(n_layers=3, d_model=64, n_heads=4, d_ff=128, vocab=600,
             max_pos=48)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads spin while they wait, and the test
    workers run at once: this file's torch work runs on one thread,
    which is as fast alone (the model is tiny) and starves no other
    worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_adamw_update_matches_jax():
    """Four steps on both sides, each learning rate from the schedule;
    steps 0 and 2 have a norm above the clip, 1 and 3 below it."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "emb": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jopt, topt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        scale = 3.0 if step % 2 == 0 else 0.02
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jn = jopt.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, js, jp,
                                 lr_scale=jcosine(step, warmup=2, total=8))
        tp, ts, tn = topt.update(_torch(grads), ts, tp,
                                 lr_scale=cosine_schedule(step, warmup=2,
                                                          total=8))
        # the norm BEFORE clipping is returned
        assert (float(tn) > 1.0) == (step % 2 == 0)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
        assert ts.count == int(js.count) == step + 1
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]),
                                           rtol=OPT_RTOL, atol=1e-9)


def test_global_norm_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (7,), (2, 2, 2))]
    want = float(jglobal_norm([jnp.asarray(x) for x in leaves]))
    tl = [torch.from_numpy(x) for x in leaves]
    assert float(global_norm(tl)) == pytest.approx(want, rel=OPT_RTOL)
    assert float(global_norm(dict(enumerate(tl)))) == pytest.approx(
        want, rel=OPT_RTOL)
    for step in (0, 5, 10, 55, 100, 150):       # 0, warm-up, total, past
        got = float(cosine_schedule(step, warmup=10, total=100, floor=0.1))
        assert got == pytest.approx(
            float(jcosine(step, warmup=10, total=100, floor=0.1)),
            rel=OPT_RTOL)


@pytest.mark.parametrize("seed", [None, 0, 3])
def test_train_batches_match_jax(seed):
    """``(seed or self.seed) + i``: a seed of 0 counts as none."""
    tb = ClassificationData(vocab=600, seq_len=32, seed=7).train_batches(
        16, seed=seed)
    jb = JData(vocab=600, seq_len=32, seed=7).train_batches(16, seed=seed)
    for _ in range(5):
        (tt, tl), (jt, jl) = next(tb), next(jb)
        assert tt.dtype == jt.dtype and tl.dtype == jl.dtype
        assert tt.tobytes() == jt.tobytes() and tl.tobytes() == jl.tobytes()


def _train_both():
    """The launcher's 150 steps from the reference's init on both sides,
    the reference's params also kept after 10 steps.  JAX trains once:
    its ``train_classifier`` loop, step for step, over its own jitted
    ``make_classifier_train_step``, stopping to copy the params at 10;
    the port's ``train_classifier`` runs 10 steps and 150."""
    cfg = jdb.config(**SMALL)
    params = jdb.init(cfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    opt = JAdamW(lr=1e-3, weight_decay=0.0)
    step_fn = jax.jit(make_classifier_train_step(cfg, opt))
    opt_state = opt.init(params)
    batches = JData(vocab=600, seq_len=32, seed=1).train_batches(32)
    jlog, snaps = [], {}
    for i in range(150):
        toks, labels = next(batches)
        params, opt_state, m = step_fn(params, opt_state, jnp.asarray(toks),
                                       jnp.asarray(labels))
        if i % 50 == 0 or i == 149:
            jlog.append(dict({k: float(v) for k, v in m.items()}, step=i))
        if i + 1 in (10, 150):
            snaps[i + 1] = (params, [r for r in jlog])
    ports = {}
    for steps in (10, 150):
        model = convert.distilbert_from_numpy(cfg, init, device="cpu")
        ports[steps] = train_classifier(
            model, ClassificationData(vocab=600, seq_len=32,
                                      seed=1).train_batches(32),
            steps=steps, verbose=False, device="cpu")
    return cfg, snaps, ports


def _check_leaves(jp, model):
    want = convert.flatten_tree(jax.tree.map(np.asarray, jp))
    got = {k.replace(".", "/"): v.numpy()
           for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max())
                for k in want if not k.endswith("/mix/bk"))
    assert worst <= LEAF_TOL
    assert all(not p.requires_grad for p in model.parameters())


def _logits(cfg, jp, model, toks):
    x = torch.from_numpy(toks).long()
    with torch.inference_mode():
        t = (model.logits(x).numpy(),
             model.early_exit_logits(x, exit_layer=1).numpy())
    j = jax.jit(lambda p, x: (jdb.logits(cfg, p, x),
                              jdb.early_exit_logits(cfg, p, x,
                                                    exit_layer=1)))(jp, toks)
    return t, tuple(np.asarray(a) for a in j)


def test_train_classifier_matches_jax():
    """One test, so that the JAX training runs once whichever worker
    takes it.  After 10 steps: leaves and logits within budget.  After
    150: leaves, the log records, a falling ``ce``, and on the
    launcher's 2,000 requests the same class from both heads on every
    request, logits within budget and the full head ahead of the exit-1
    proxy, which is what the controller trades on."""
    cfg, snaps, ports = _train_both()
    (jp, _), (model, _) = snaps[10], ports[10]
    _check_leaves(jp, model)
    toks, _, _ = ClassificationData(vocab=600, seq_len=32, seed=5).sample(256)
    for t, j in zip(*_logits(cfg, jp, model, toks)):
        assert np.abs(t - j).max() <= LOGIT_TOL

    (jp, jlog), (model, tlog) = snaps[150], ports[150]
    _check_leaves(jp, model)
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    assert [r["step"] for r in tlog] == [0, 50, 100, 149]
    for tr, jr in zip(tlog, jlog):
        for k in ("ce", "ce_exit", "grad_norm"):
            assert tr[k] == pytest.approx(jr[k], rel=1e-3, abs=LOGIT_TOL)
    assert tlog[-1]["ce"] < tlog[0]["ce"]

    toks, labels, _ = ClassificationData(vocab=600, seq_len=32,
                                         seed=1).sample(2000)
    (tf, te), (jf, je) = _logits(cfg, jp, model, toks)
    for t, j in ((tf, jf), (te, je)):
        assert np.abs(t - j).max() <= LOGIT_TOL
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))
    acc_full = (tf.argmax(-1) == labels).mean()
    acc_exit = (te.argmax(-1) == labels).mean()
    assert acc_full > acc_exit > 0.5
