"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the reference's ``repro.models.mla``, on the CPU.

The minicpm3-4b smoke config's MLA (4 heads, q_lora 48, kv_lora 32,
nope 16, rope 8, v 16: q and k of 24 features, v of 16) and a variant
without the q low-rank path, f32 weights from the reference's
``mla_params`` carried across by ``convert.load_state``, numpy inputs:
``mla_attention`` (the expanded prefill form, at a q offset too),
``mla_cache_write`` at a scalar and a per-slot [B] start, wrapping a
ring (start + S past the cache), and ``mla_decode`` (the absorbed step,
scalar and [B] positions, over a cache that has wrapped).  Outputs and
cache contents within 2e-5 (f32: sums in another order; |y| ~ 1), the
positions exactly.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

TOL = 2e-5
ARCH = "minicpm3-4b"


@pytest.fixture(scope="module", params=[True, False],
                ids=["q_lora", "no_q_lora"])
def pair(request):
    cfg = jget(ARCH)
    if not request.param:
        cfg = cfg.replace(q_lora_rank=0)
    jm = jtfm._mla_cfg(cfg)
    tm = ttfm.mla_config(tget(ARCH).replace(q_lora_rank=cfg.q_lora_rank))
    assert tuple(jm) == tuple(tm)
    p = jmla.mla_params(jax.random.PRNGKey(1), cfg.d_model, jm)
    tp = tmla.MLAParams(cfg.d_model, tm, device="cpu")
    convert.load_state(tp, convert.flatten_tree(jax.tree.map(np.asarray, p)))
    return jm, p, tp, cfg.d_model


def _x(B, S, d, seed=4):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - b.float().numpy()).max())


@pytest.mark.parametrize("q_offset", [0, 5])
def test_mla_attention_matches_jax(pair, q_offset):
    jm, p, tp, d = pair
    jx, tx = _x(2, 9, d)
    y1 = jmla.mla_attention(p, jm, jx, q_offset=q_offset)
    y2 = tmla.mla_attention(tp, tx, q_offset=q_offset)
    assert y2.shape == (2, 9, d) and _err(y1, y2) < TOL


def _caches(jm, B, C):
    jc = jmla.init_mla_cache(B, C, jm, dtype=jnp.float32)
    tc = tmla.init_mla_cache(B, C, jm, dtype=torch.float32, device="cpu")
    return jc, tc


def _same_cache(jc, tc):
    assert _err(jc.c_kv, tc.c_kv) < TOL
    assert _err(jc.k_rope, tc.k_rope) < TOL
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())


@pytest.mark.parametrize("start", ["scalar", "per_slot"])
def test_mla_cache_write_matches_jax_and_wraps(pair, start):
    """Two writes into a 6-row ring: 4 tokens, then 4 more from position
    4 (scalar) or from [4, 2] (per slot), so rows wrap."""
    jm, p, tp, d = pair
    jc, tc = _caches(jm, 2, 6)
    jx, tx = _x(2, 4, d)
    jc = jmla.mla_cache_write(p, jm, jc, jx, 0)
    assert tmla.mla_cache_write(tp, tc, tx, 0) is tc
    _same_cache(jc, tc)
    jx, tx = _x(2, 4, d, seed=5)
    s = 4 if start == "scalar" else np.array([4, 2], np.int32)
    ts = s if start == "scalar" else torch.from_numpy(s).long()
    jc = jmla.mla_cache_write(p, jm, jc, jx, s)
    tmla.mla_cache_write(tp, tc, tx, ts)
    _same_cache(jc, tc)
    assert int(tc.pos.max()) == 7


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
def test_mla_decode_matches_jax(pair, pos):
    """Prefill 5 tokens into a 7-row ring, then 4 absorbed decode steps
    (the last two wrap): outputs and the cache each step."""
    jm, p, tp, d = pair
    jc, tc = _caches(jm, 2, 7)
    jx, tx = _x(2, 5, d)
    jc = jmla.mla_cache_write(p, jm, jc, jx, 0)
    tmla.mla_cache_write(tp, tc, tx, 0)
    offs = np.array([0, 0] if pos == "scalar" else [0, -2])
    for i in range(4):
        jx, tx = _x(2, 1, d, seed=10 + i)
        at = 5 + i + offs
        jp = 5 + i if pos == "scalar" else jnp.asarray(at, jnp.int32)
        tpos = 5 + i if pos == "scalar" else torch.from_numpy(at).long()
        y1, jc = jmla.mla_decode(p, jm, jx, jc, pos=jp)
        y2, out = tmla.mla_decode(tp, tx, tc, pos=tpos)
        assert out is tc and y2.shape == (2, 1, d)
        assert _err(y1, y2) < TOL, i
        _same_cache(jc, tc)


def test_mla_prefill_is_attention_plus_write(pair):
    """The model's prefill helper projects the latents once: the same
    output as ``mla_attention`` and the same cache as a write from 0."""
    jm, p, tp, d = pair
    _, tx = _x(2, 6, d)
    _, tc = _caches(jm, 2, 8)
    _, tc2 = _caches(jm, 2, 8)
    y = tmla.mla_prefill(tp, tc, tx)
    assert torch.equal(y, tmla.mla_attention(tp, tx))
    tmla.mla_cache_write(tp, tc2, tx, 0)
    for a, b in ((tc.c_kv, tc2.c_kv), (tc.k_rope, tc2.k_rope),
                 (tc.pos, tc2.pos)):
        assert torch.equal(a, b)
