"""The port's LM training against the JAX reference, on the CPU.

One ``make_train_step`` step on each side, from the reference's
``init_lm`` weights (carried across by ``convert.lm_from_numpy``) on the
same ``lm_batches`` batch, for the smoke config of every family in f32:
the loss and aux within 1e-5 relative, the grad norm within 1e-4
relative, the lr scale to 1e-7, the metrics' keys equal; the first
moment after the step (0.1 x the clipped gradient) within 1e-4 of each
leaf's largest; the parameters after the step within 1e-6 wherever the
clipped gradient is at least 100 x Adam's eps, and within a step's
length (2.1 x the learning rate) elsewhere, where Adam's first step
turns on the gradient's rounding noise (the constants say why).  The
attention key biases ``mix/bk`` are set apart from the moment check: a
constant added to every score of a query leaves its softmax unchanged,
so their true gradient is zero and each side's is rounding noise.
Measured on an Intel Xeon CPU, PyTorch 2.13 against JAX 0.9: the loss
within 1.1e-7 relative, the norm within 4.9e-7, the moments within
2.4e-6 of their leaf's largest, the parameters within 3e-8 where the
gradient is well away from 0 and 3.5e-5 where it is not.

mamba2's reference step overflows at this batch (dt up to ~3 over a
chunk of 8 at A = -16 passes exp's range; ROADMAP queue 3): its NaN is
checked, and the port is held against the reference's step with the
intra-chunk decay masked before its exponential, the one repair the
port makes.

Also: ``AdamW.update_`` against ``update`` and the reference's; the
three remat policies give the same loss and gradients and recompute
what they say; the reference's overfit check; ``lm_batches`` byte for
byte; the SSD path at mamba2's chunk of 256; ``attn_impl="cuda"``
refused under grad; and the launcher end to end on the CPU, which
refuses to start without a card unless asked for the CPU.
"""
import collections
import functools
import json
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import cosine_schedule as jcosine  # noqa: E402
from repro.training import lm_batches as jlm_batches  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked_plain  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.training import (AdamW, cosine_schedule,  # noqa: E402
                                  lm_batches, lm_loss, make_train_step)

ARCHS = ["stablelm-3b", "llama3-405b", "granite-moe-3b-a800m", "mamba2-780m",
         "minicpm3-4b", "recurrentgemma-2b", "paligemma-3b", "whisper-medium"]
LR, STEPS, WARMUP = 1e-3, 10, 2
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
GRAD_RTOL = 1e-4
# the first step moves a parameter by LR * g / (|g| + 1e-8) (+ weight
# decay): where the clipped |g| >= 100 x 1e-8 (the first moment, 0.1 g,
# >= 1e-7) it is within LR * 1e-2 of LR * sign(g) and a gradient
# difference of 1e-6 of its size moves it by under 1e-9, so the
# parameters agree to f32's rounding: 1e-6; where |g| is nearer 0 the
# step turns on the gradient's rounding noise (up to 1 / 1e-8 per unit
# of g), so there only its length is bounded, by 2.1 LR
WELL_M = 0.1 * 100 * 1e-8
PARAM_TOL = 1e-6
BOUNDED_STEP = 2.1 * LR


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers run at once: this file's torch work runs on one
    thread (the models are tiny) and starves no other worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1, batch=2, seq=12):
    """numpy tokens [B, S+1] from ``lm_batches`` plus the family's
    frontend stubs from a seeded numpy generator."""
    out = {"tokens": next(lm_batches(vocab=cfg.vocab, batch=batch,
                                     seq_len=seq, seed=seed))}
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        out["enc_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.enc_seq, cfg.enc_d_model or cfg.d_model))
        ).astype(np.float32)
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _masked_ssd_chunked(x, dt, A, Bm, Cm, h0, chunk):
    """``repro.models.ssd.ssd_chunked`` with the one repair the port
    makes (``ssd_chunked_plain``): the intra-chunk decay masked before
    its exponential.  The forward is the reference's; the gradient is
    finite where the reference's overflows (``exp(l_t - l_s)`` for
    s > t, which the reference masks only after)."""
    B_, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        Bm = jnp.pad(Bm, ((0, 0), (0, pad), (0, 0)))
        Cm = jnp.pad(Cm, ((0, 0), (0, pad), (0, 0)))
    xc = x.reshape(B_, nc, Q, H, hd)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, N)
    Cc = Cm.reshape(B_, nc, Q, N)
    l = jnp.cumsum(A[None, None, None, :] * dtc, axis=2)
    cb = jnp.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    decay = jnp.transpose(l[:, :, :, None, :] - l[:, :, None, :, :],
                          (0, 1, 4, 2, 3))
    mask = jnp.tril(jnp.ones((Q, Q), bool))
    att = jnp.where(mask, jnp.exp(jnp.where(mask, decay, -jnp.inf))
                    * cb[:, :, None], 0.0)
    att = att * dtc.transpose(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = jnp.einsum("bchts,bcshd->bcthd", att, xc)
    w = jnp.exp(l[:, :, -1:, :] - l) * dtc
    states = jnp.einsum("bcqh,bcqn,bcqhd->bchdn", w, Bc, xc)

    def step(h_prev, inp):
        s_c, dec = inp
        return dec[:, :, None, None] * h_prev + s_c, h_prev

    h_last, h_prevs = jax.lax.scan(
        step, h0, (jnp.moveaxis(states, 1, 0),
                   jnp.moveaxis(jnp.exp(l[:, :, -1, :]), 1, 0)))
    y_inter = jnp.einsum("bcqn,bchdn,bcqh->bcqhd", Cc,
                         jnp.moveaxis(h_prevs, 0, 1), jnp.exp(l))
    y = (y_intra + y_inter).reshape(B_, nc * Q, H, hd)
    return y[:, :S], h_last


@functools.lru_cache(maxsize=None)
def _reference_step(arch, repaired=True):
    """The reference's init and one jitted train step on it, as numpy:
    (init params, batch, params after, the first moment after, metrics).
    An SSD stack's step runs ``_masked_ssd_chunked`` unless
    ``repaired`` is False (its gradient overflows at this batch: dt up
    to ~3 over a chunk of 8 at A = -16 passes exp's range)."""
    jcfg = jget(arch).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    opt = JAdamW(lr=LR)
    step = jax.jit(jmake_train_step(jcfg, opt, total_steps=STEPS,
                                    warmup=WARMUP))
    with mock.patch.object(jssd, "ssd_chunked", _masked_ssd_chunked
                           if repaired else jssd.ssd_chunked):
        new, st, m = step(params, opt.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(params), batch, convert.flatten_tree(to_np(new)),
            convert.flatten_tree(to_np(st.m)),
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    params, batch, want, want_m, jm = _reference_step(arch)
    cfg = tget(arch).replace(dtype="float32")
    model = convert.lm_from_numpy(cfg, params, device="cpu")
    opt = AdamW(lr=LR)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt, total_steps=STEPS, warmup=WARMUP)
    state, tm = step(model, state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert set(tm) == set(jm) and state.count == 1
    tm = {k: float(v) for k, v in tm.items()}
    for k in ("loss", "total"):
        assert abs(tm[k] - jm[k]) <= LOSS_RTOL * abs(jm[k]), k
    assert abs(tm["aux"] - jm["aux"]) <= LOSS_RTOL * max(abs(jm["aux"]), 1e-3)
    assert (tm["aux"] > 0) == cfg.is_moe
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= NORM_RTOL * jm["grad_norm"]
    assert tm["lr_scale"] == pytest.approx(jm["lr_scale"], rel=1e-7)
    got = {k: t.numpy() for k, t in convert.lm_to_flat(model).items()}
    got_m = {k: t.numpy() for k, t in convert.lm_flat(cfg, state.m).items()}
    init = convert.flatten_tree(params)
    assert set(got) == set(want) == set(got_m)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = np.abs(got[k] - w)
        well = np.abs(want_m[k]) >= WELL_M
        assert err[well].max(initial=0.0) <= PARAM_TOL, k
        assert err.max() <= BOUNDED_STEP, k
        assert not np.array_equal(w, init[k]), k
        if k.split("/")[-1] == "bk":
            continue
        scale = np.abs(want_m[k]).max()
        assert scale > 0, k
        assert np.abs(got_m[k] - want_m[k]).max() <= GRAD_RTOL * scale, k


def test_reference_ssd_gradient_overflows():
    """The fault the port repairs: the reference's own mamba2 step at
    the same batch has a NaN gradient norm and NaN parameters after."""
    _, _, want, _, jm = _reference_step("mamba2-780m", repaired=False)
    assert np.isfinite(jm["loss"]) and not np.isfinite(jm["grad_norm"])
    assert not np.isfinite(want["emb"]).all()


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _grads(model, tokens):
    """(loss, gradients, the ops the backward dispatched)."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        loss, _ = lm_loss(model, tokens)
        with _CountOps() as count:
            grads = torch.autograd.grad(loss, params)
    finally:
        for p in params:
            p.requires_grad_(False)
    return loss.detach(), grads, count.ops


def test_remat_policies_agree():
    """The same loss and gradients under each policy (they change what
    is recomputed, never the math), and the backward recomputes what the
    policy says: ``full`` the layers' products (``mm``) and attention
    (``bmm``), ``dots`` the attention only, having saved the products."""
    base = tget("stablelm-3b").replace(dtype="float32", n_layers=3)
    tokens = torch.from_numpy(_batch(base, seq=16)["tokens"])
    out = {}
    for pol in ("none", "dots", "full"):
        cfg = base.replace(remat=pol != "none", remat_policy=pol)
        out[pol] = _grads(ttfm.init_lm(cfg, 3, device="cpu"), tokens)
    for pol in ("dots", "full"):
        assert torch.equal(out[pol][0], out["none"][0])
        for a, b in zip(out[pol][1], out["none"][1]):
            assert torch.equal(a, b)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    none, dots, full = out["none"][2], out["dots"][2], out["full"][2]
    assert none[mm] == dots[mm] < full[mm]
    assert none[bmm] < dots[bmm] == full[bmm]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_place_matches_functional_and_jax(dtype):
    """The in-place ``AdamW.update_`` and the functional ``update``:
    four steps from the same params and gradients (norms above and below
    the clip, the learning rate from the schedule) give the same bits,
    the functional form leaving its inputs alone; both the reference's,
    as ``tests/test_torch_training.py`` holds ``update`` (1e-6 relative;
    bf16 params to one bf16 rounding)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "emb": (3, 4, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    opt, jopt = AdamW(lr=1e-2), JAdamW(lr=1e-2)
    fp = {k: torch.from_numpy(v).to(dtype) for k, v in init.items()}
    ip = {k: v.clone() for k, v in fp.items()}
    jp = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for k, v in fp.items()}
    fs, is_, js = opt.init(fp), opt.init(ip), jopt.init(jp)
    for step in range(4):
        scale = 3.0 if step % 2 == 0 else 0.02
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        tg = {k: torch.from_numpy(g).to(dtype) for k, g in grads.items()}
        lr = cosine_schedule(step, warmup=2, total=8)
        before = {k: t.clone() for k, t in fp.items()}
        fp_old, fs_m_old = fp, {k: t.clone() for k, t in fs.m.items()}
        fs_old = fs
        fp, fs, fn = opt.update(tg, fs, fp, lr_scale=lr)
        assert all(torch.equal(fp_old[k], before[k]) for k in shapes)
        assert all(torch.equal(fs_old.m[k], fs_m_old[k]) for k in shapes)
        is_, inorm = opt.update_(tg, is_, ip, lr_scale=lr)
        jp, js, jn = jopt.update({k: jnp.asarray(g.float().numpy()).astype(
            jp[k].dtype) for k, g in tg.items()}, js, jp,
            lr_scale=jcosine(step, warmup=2, total=8))
        assert torch.equal(fn, inorm) and fs.count == is_.count == step + 1
        for k in shapes:
            assert torch.equal(fp[k], ip[k]) and fp[k].dtype == dtype
            assert torch.equal(fs.m[k], is_.m[k])
            assert torch.equal(fs.v[k], is_.v[k])
            np.testing.assert_allclose(is_.m[k].numpy(), np.asarray(js.m[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(
                ip[k].float().numpy(), np.asarray(jp[k], np.float32),
                rtol=1e-6 if dtype == torch.float32 else 2 ** -8, atol=1e-9)
        assert float(inorm) == pytest.approx(float(jn), rel=1e-6)


def test_lm_train_step_loss_decreases():
    """The reference's overfit check: 15 steps on one batch."""
    cfg = tget("llama3-405b")
    model = ttfm.init_lm(cfg, 0, device="cpu")
    opt = AdamW(lr=3e-3)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt, warmup=1)
    batch = {"tokens": torch.from_numpy(next(lm_batches(
        vocab=cfg.vocab, batch=8, seq_len=24, seed=1)))}
    losses = []
    for _ in range(15):
        state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2


@pytest.mark.parametrize("seed", [0, 5])
def test_lm_batches_match_jax(seed):
    kw = dict(vocab=512, batch=4, seq_len=32, seed=seed)
    for a, b, _ in zip(lm_batches(**kw), jlm_batches(**kw), range(3)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_ssd_chunk_256_gradient_finite():
    """mamba2's published chunk (256) with its A range (-1 .. -16 over
    the heads) and dt = softplus(0) ~ 0.69: l_t - l_s for s > t reaches
    about 2,800, past f32's exp.  The reference's gradient is NaN there;
    the port's is finite and its forward equals the reference's."""
    rng = np.random.default_rng(0)
    B, S, H, hd, N = 1, 256, 4, 4, 8
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.full((B, S, H), np.log1p(np.exp(0.0)), np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = np.zeros((B, H, hd, N), np.float32)

    def jloss(dt_):
        y, _ = jssd.ssd_chunked(x, dt_, A, Bm, Cm, h0, 256)
        return jnp.sum(y), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jg)).all()
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, _ = ssd_chunked_plain(torch.from_numpy(x), tdt, torch.from_numpy(A),
                              torch.from_numpy(Bm), torch.from_numpy(Cm),
                              torch.from_numpy(h0), 256)
    (tg,) = torch.autograd.grad(ty.sum(), tdt)
    assert torch.isfinite(tg).all() and tg.abs().max() > 0
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-780m"])
def test_cuda_forced_under_grad_raises(arch):
    """No kernel has a backward: a forward whose layers need gradients
    refuses ``attn_impl="cuda"`` before any kernel runs; with the
    parameters frozen, or under ``no_grad``, the kernel is called (and
    on CPU tensors refuses them itself)."""
    model = ttfm.init_lm(tget(arch), 0, device="cpu")
    model.attn_impl = "cuda"
    tokens = torch.zeros(1, 9, dtype=torch.long)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        lm_loss(model, tokens)
    for p in model.parameters():
        p.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        lm_loss(model, tokens)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="needs a CUDA tensor"):
        lm_loss(model, tokens)


def test_launcher_trains_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    out = tlaunch.main(["--device", "cpu", "--arch", "stablelm-3b",
                        "--steps", "6", "--batch", "4", "--seq", "16",
                        "--runs", str(tmp_path), "--checkpoint", ck])
    assert out["last_loss"] < out["first_loss"]
    assert set(out) >= {"first_loss", "last_loss", "run_dir", "energy_j",
                        "co2_kg"}
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == out
    with np.load(ck) as z:
        assert "params/layers/mix/wq" in z.files and int(z["opt/count"]) == 6
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tlaunch.main(["--runs", str(tmp_path)])
