"""The port's MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe.moe_forward``, on the CPU.

The same router and experts (the reference's ``moe_params``, carried
across by ``convert.load_state``) and the same numpy inputs go through
both.  Cases: one group of N = 14 tokens, and N = 15 in groups of 4 (G =
4 > 1, the last group zero-padded), at capacity factors 4.0 (nothing
drops), 1.25 and 0.5 (tokens drop), in f32 and in bf16.  Tolerances:
f32 outputs within 1e-5 (|y| ~ 1: the f32 sums differ in order only);
bf16 outputs within 2^-6 of the call's largest |y|, four bf16 ulps
there: the bf16 products are bitwise equal, but the reference's SiLU
is XLA's bf16 logistic, rounded, times x, where the port's computes in
f32 and rounds once, so about 40 % of the hidden activations sit one
bf16 ulp apart, which the down projection's sums carry into the
outputs (two ulps of the largest output measured); and the aux loss
within 1e-6 in both (f32 means over the same gates).  The
assignment itself (expert, row in the expert, kept or dropped) is
checked exactly against a numpy loop over k-slots written as the
reference's one-hot rule, and exact router ties go to the lower
expert, as ``jax.lax.top_k`` breaks them.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

D, F, E, K = 32, 48, 4, 2
CASES = {"one_group": (2, 7, 1024), "padded_groups": (3, 5, 4)}


def _params(dtype, tie=False, seed=0):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    p = jmoe.moe_params(jax.random.PRNGKey(seed), D, E, F, dtype=jdt)
    if tie:      # experts 1 and 2 get bitwise-equal router logits
        p["router"] = p["router"].at[:, 2].set(p["router"][:, 1])
    tp = tmoe.MoEParams(D, E, F, device="cpu", dtype=dtype)
    convert.load_state(tp, convert.flatten_tree(jax.tree.map(np.asarray, p)))
    return p, tp


def _x(B, S, dtype, seed=3):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    return jx, torch.from_numpy(x).to(dtype)


def _numpy_assignment(idx, C):
    """The reference's k-slot position priority (``moe.py:92-108``), one
    k-slot at a time: -> (pos, keep), both [G, g, k]."""
    G, g, k = idx.shape
    counts = np.zeros((G, E), np.int64)
    pos = np.zeros(idx.shape, np.int64)
    keep = np.zeros(idx.shape, bool)
    for j in range(k):
        m = np.eye(E, dtype=np.int64)[idx[..., j]]               # [G,g,E]
        p = np.cumsum(m, axis=1) - 1 + counts[:, None, :]
        kp = (p < C) & (m > 0)
        pos[..., j] = np.take_along_axis(p, idx[..., j, None], -1)[..., 0]
        keep[..., j] = np.take_along_axis(kp, idx[..., j, None], -1)[..., 0]
        counts = counts + (m * kp).sum(axis=1)
    return pos, keep


def _groups(tx, group):
    B, S, _ = tx.shape
    N = B * S
    g = min(group, N)
    G = -(-N // g)
    xt = torch.nn.functional.pad(tx.reshape(N, D), (0, 0, 0, G * g - N))
    return xt.reshape(G, g, D)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_forward_matches_jax(case, cf, dtype):
    B, S, group = CASES[case]
    p, tp = _params(dtype)
    jx, tx = _x(B, S, dtype)
    y1, a1 = jmoe.moe_forward(p, jx, top_k=K, capacity_factor=cf,
                              group_size=group)
    y2, a2 = tmoe.moe_forward(tp, tx, top_k=K, capacity_factor=cf,
                              group_size=group)
    assert y2.shape == (B, S, D) and y2.dtype == dtype
    y1 = np.asarray(y1.astype(jnp.float32))
    err = np.abs(y1 - y2.float().numpy())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * np.abs(y1).max()
    assert err.max() <= tol
    assert abs(float(a1) - float(a2)) < 1e-6
    # the assignment: exact, and drops where the capacity says so
    _, w, idx, pos, keep, C = tmoe.route(tp.router, _groups(tx, group), K, cf)
    want_pos, want_keep = _numpy_assignment(idx.numpy(), C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos.numpy()[want_keep],
                                  want_pos[want_keep])
    dropped = int((~keep).sum())
    if cf == 4.0:
        assert dropped == 0
    if cf == 0.5:
        assert dropped > 0
    assert torch.allclose(w.sum(-1), torch.ones(()), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_router_ties_go_to_the_lower_expert(dtype):
    """Experts 1 and 2 have one router column: wherever they tie for a
    top-k place (or every expert ties, on a zero padding row), the lower
    index is taken first, as ``jax.lax.top_k``; the outputs agree."""
    p, tp = _params(dtype, tie=True)
    jx, tx = _x(3, 5, dtype)
    xg = _groups(tx, 4)
    gates, _, idx, _, _, _ = tmoe.route(tp.router, xg, 1, 1.25)
    jg = jax.nn.softmax(jnp.asarray(xg.float().numpy())
                        @ p["router"].astype(jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(jg, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tied = gates[..., 1] == gates[..., 2]
    assert bool(tied.all())
    assert not bool((idx == 2).any())        # 1 always wins the tie
    assert bool((idx[-1, -1] == 0).all())     # the padding row: expert 0
    y1, a1 = jmoe.moe_forward(p, jx, top_k=1, capacity_factor=1.25,
                              group_size=4)
    y2, a2 = tmoe.moe_forward(tp, tx, top_k=1, capacity_factor=1.25,
                              group_size=4)
    y1 = np.asarray(y1.astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * np.abs(y1).max()
    assert np.abs(y1 - y2.float().numpy()).max() <= tol
    assert abs(float(a1) - float(a2)) < 1e-6


def test_capacity_and_decode_without_aux():
    """The capacity rule at the served shapes (granite: E 40, k 8, cf
    1.25): 8 decode slots keep everything, 16 slots drop; and a call
    without the aux returns None beside the same output."""
    assert tmoe.capacity(8, 8, 40, 1.25) == 8
    assert tmoe.capacity(16, 8, 40, 1.25) == 8
    assert tmoe.capacity(128, 8, 40, 1.25) == 32
    assert tmoe.capacity(4, 2, 4, 0.5) == 2
    _, tp = _params(torch.float32)
    _, tx = _x(2, 7, torch.float32)
    y, aux = tmoe.moe_forward(tp, tx, top_k=K, capacity_factor=1.25)
    y2, none = tmoe.moe_forward(tp, tx, top_k=K, capacity_factor=1.25,
                                need_aux=False)
    assert none is None and torch.equal(y, y2) and aux.dim() == 0
