"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's (``repro.models.rglru``) on the CPU, from the same numpy
inputs and the reference's own ``rglru_params``.

Tolerance: 1e-4 in f32, ``tests/test_models.py``'s for the scan against
the step.  The port's log-depth scan and the reference's
``jax.lax.associative_scan`` combine the same (a, b) pairs in other
orders, so they differ by sum order only; a 1,200-token prompt runs
eleven passes of the port's scan, where a dropped or misplaced pass
would be off by the state itself.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import rglru as jrg  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

TOL = 1e-4
D, R, W = 32, 16, 4


def _params(seed=0, width=R):
    jp = jrg.rglru_params(jax.random.PRNGKey(seed), D, width, W)
    # non-zero gate biases, so that they are exercised too
    rng = np.random.default_rng(seed)
    jp = dict(jp, b_a=jnp.asarray(rng.normal(0, 0.5, width), jnp.float32),
              b_x=jnp.asarray(rng.normal(0, 0.5, width), jnp.float32),
              conv_b=jnp.asarray(rng.normal(0, 0.1, width), jnp.float32))
    tp = trg.RGLRUParams(D, width, W, device="cpu")
    convert.load_state(tp, convert.flatten_tree(jax.tree.map(np.asarray, jp)))
    return jp, tp


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [1, 7, 20, 1200])
def test_scan_matches_jax_and_the_step(S):
    jp, tp = _params()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, R)).astype(np.float32)
    h0 = rng.standard_normal((2, R)).astype(np.float32)
    y_j, h_j = jax.jit(jrg.rglru_scan)(jp, jnp.asarray(x), jnp.asarray(h0))
    y_t, h_t = trg.rglru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
    _close(y_j, y_t)
    _close(h_j, h_t)
    # the step, token by token from the same h0
    h = torch.from_numpy(h0)
    ys = []
    for t in range(S):
        y, h = trg.rglru_step(tp, torch.from_numpy(x[:, t:t + 1]), h)
        ys.append(y[:, 0])
    _close(y_t.numpy(), torch.stack(ys, 1))
    _close(h_t.numpy(), h)


def test_step_matches_jax():
    jp, tp = _params(1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, R)).astype(np.float32)
    h = rng.standard_normal((3, R)).astype(np.float32)
    y_j, h_j = jrg.rglru_step(jp, jnp.asarray(x), jnp.asarray(h))
    y_t, h_t = trg.rglru_step(tp, torch.from_numpy(x), torch.from_numpy(h))
    _close(y_j, y_t, 1e-6)
    _close(h_j, h_t, 1e-6)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the loop it replaces, at a length
    that is no power of two, with decays down to 0.9 over 1,000 steps:
    the product of the a's underflows long before the end, which the
    exp(cumsum(log a)) form would turn into inf * 0."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.9, 1.0, (2, 1000, 8)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 1000, 8)).astype(
        np.float32))
    h, want = torch.zeros(2, 8), []
    for t in range(1000):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = trg.linear_scan(a, b)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("single_step", [False, True], ids=["scan", "step"])
def test_block_from_a_nonzero_state_matches_jax(single_step):
    """The whole block (projections, the conv after a non-zero tail, the
    scan or the step from a non-zero h, the GELU gate) and the state it
    leaves, updated in place on the port's side."""
    jp, tp = _params(2)
    rng = np.random.default_rng(5)
    S = 1 if single_step else 13
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    h0 = rng.standard_normal((2, R)).astype(np.float32)
    tail = rng.standard_normal((2, W - 1, R)).astype(np.float32)
    y_j, st_j = jrg.rglru_block(
        jp, jnp.asarray(x), jrg.RGLRUState(h=jnp.asarray(h0),
                                           conv=jnp.asarray(tail)),
        single_step=single_step)
    st_t = trg.RGLRUState(h=torch.from_numpy(h0.copy()),
                          conv=torch.from_numpy(tail.copy()))
    y_t = trg.rglru_block(tp, torch.from_numpy(x), st_t,
                          single_step=single_step)
    _close(y_j, y_t)
    _close(st_j.h, st_t.h)
    _close(st_j.conv, st_t.conv)


def test_block_without_state_is_the_zero_state():
    jp, tp = _params(3)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 9, D)).astype(np.float32))
    st = trg.init_rglru_state(2, R, W, device="cpu")
    _close(trg.rglru_block(tp, x, None).numpy(), trg.rglru_block(tp, x, st),
           0.0)
    assert st.h.abs().sum() > 0 and st.conv.abs().sum() > 0


def test_init_follows_the_reference():
    """Seeded weights keep the reference's shapes, types and scales:
    Lambda spread over [3, 7], zero biases, gate weights 100 times
    smaller than a fan-in init."""
    tp = trg.RGLRUParams(D, R, W, device="cpu", dtype=torch.bfloat16)
    tp.reset_parameters(torch.Generator().manual_seed(0))
    jp = jrg.rglru_params(jax.random.PRNGKey(0), D, R, W,
                          dtype=jnp.bfloat16)
    for name, a in jp.items():
        t = getattr(tp, name)
        assert tuple(t.shape) == a.shape and str(t.dtype).endswith(
            str(a.dtype)), name
    np.testing.assert_allclose(tp.lam.numpy(), np.asarray(jp["lam"]), rtol=1e-6)
    assert tp.b_a.abs().sum() == 0 and tp.conv_b.float().abs().sum() == 0
    assert 0 < float(tp.w_a.float().abs().max()) <= 0.0201   # 2 sigma
    assert float(tp.w_in.float().abs().max()) > 0.1
