"""The port's sampling module (``repro_torch.serving.sampling``) against
``repro.serving.sampling`` and ``jax.random``, on the CPU.

Keys and random bits are integers and must be equal bit for bit: the
Threefry-2x32 hash, ``PRNGKey``, ``fold_in``, ``split``, ``step_keys``
(``jax.vmap(jax.random.fold_in)``) and the bits of a shape in jax's
partitionable layout.  The Gumbel floats go through ``log`` twice, and
torch's ``log`` and XLA's may round the last bit apart: the inner
``-log(u)`` is near 1 where ``g`` is near 0, so a one-ulp difference
there moves ``g`` by one ulp of 1, not of ``g``.  The bound is
therefore stated in units of ``eps * max(1, |g|)``: 2 for float32
(measured: 1), 1 for bfloat16 (measured: 0).  Masks and sampled tokens
are compared exactly, on logits with ties; ``hypothesis`` properties
run with ``deadline=None`` (a first JIT compile takes longer than its
default deadline).
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import sampling as js  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402

GUMBEL_ULPS = {torch.float32: 2.0, torch.bfloat16: 1.0}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _keys(n, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
@pytest.mark.parametrize("rid", [0, 1, 7, 65_537, 2 ** 31 - 1])
def test_request_key_matches_jax(seed, rid):
    np.testing.assert_array_equal(ts.request_key(seed, rid),
                                  js.request_key(seed, rid))
    np.testing.assert_array_equal(ts.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_fold_in_and_split_match_jax(num):
    for k in _keys(4, seed=num):
        np.testing.assert_array_equal(
            ts.fold_in(k, 12345), np.asarray(jax.random.fold_in(k, 12345)))
        np.testing.assert_array_equal(
            ts.split(k, num), np.asarray(jax.random.split(k, num)))


def test_step_keys_match_vmapped_fold_in():
    keys = _keys(16, seed=1)
    pos = np.random.default_rng(2).integers(0, 2 ** 31 - 1, 16,
                                            dtype=np.int64).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(pos)))
    got = ts.step_keys(_t(keys), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        got, ts.step_keys(torch.from_numpy(keys.astype(np.int64)),
                          torch.from_numpy(pos.astype(np.int64))).numpy())


@pytest.mark.parametrize("shape", [(1,), (37,), (1031,), (3, 50)])
def test_random_bits_match_jax_exactly(shape):
    keys = _keys(4, seed=len(shape) + shape[-1])
    want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), shape,
                                                jnp.uint32)) for k in keys])
    got = ts.random_bits(_t(keys), shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gumbel_within_stated_ulps_of_jax(dtype):
    V = 4099
    keys = _keys(8, seed=3)
    want = np.stack([np.asarray(jax.random.gumbel(
        jnp.asarray(k), (V,), JNP[dtype]).astype(jnp.float32))
        for k in keys]).astype(np.float64)
    got = ts.gumbel(_t(keys), (V,), dtype).float().numpy()
    eps = torch.finfo(dtype).eps
    err = np.abs(got - want) / (eps * np.maximum(1.0, np.abs(want)))
    assert err.max() <= GUMBEL_ULPS[dtype], err.max()
    # u >= tiny, so g >= -log(-log(tiny)) = -4.4698
    assert np.isfinite(got).all() and got.min() >= -4.4698


def _tied_logits(B, V, seed):
    """Logits on a coarse grid (many ties), one exact ±0 pair per row."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, V)) * 2).astype(np.float32)
    x[:, 0], x[:, 1] = 0.0, -0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_match_jax_on_ties(seed):
    lg = _tied_logits(6, 40, seed)
    k = np.array([0, 1, 3, 7, 39, 40], np.int32)
    p = np.array([0.05, 0.3, 0.5, 0.9, 1.0, 0.99], np.float32)
    np.testing.assert_array_equal(
        ts.top_k_mask(torch.from_numpy(lg), torch.from_numpy(k)).numpy(),
        np.asarray(js.top_k_mask(jnp.asarray(lg), jnp.asarray(k))))
    np.testing.assert_array_equal(
        ts.top_p_mask(torch.from_numpy(lg), torch.from_numpy(p)).numpy(),
        np.asarray(js.top_p_mask(jnp.asarray(lg), jnp.asarray(p))))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(0, 48),
       p=st.floats(0.05, 1.0))
def test_masks_match_jax_property(seed, k, p):
    lg = _tied_logits(2, 37, seed)
    kk, pp = np.array([k, 0], np.int32), np.array([p, p], np.float32)
    np.testing.assert_array_equal(
        ts.top_k_mask(torch.from_numpy(lg), torch.from_numpy(kk)).numpy(),
        np.asarray(js.top_k_mask(jnp.asarray(lg), jnp.asarray(kk))))
    np.testing.assert_array_equal(
        ts.top_p_mask(torch.from_numpy(lg), torch.from_numpy(pp)).numpy(),
        np.asarray(js.top_p_mask(jnp.asarray(lg), jnp.asarray(pp))))


def _sample_both(keys, lg, temp, k, p):
    want = np.asarray(js.sample_token(jnp.asarray(keys), jnp.asarray(lg),
                                      jnp.asarray(temp), jnp.asarray(k),
                                      jnp.asarray(p)))
    got = ts.sample_token(_t(keys), torch.from_numpy(lg),
                          torch.from_numpy(temp), torch.from_numpy(k),
                          torch.from_numpy(p)).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_token_matches_jax_on_mixed_batches(seed):
    """Rows at T = 0 and T > 0 in one batch, top-k and top-p on and off,
    logits with ties."""
    B, V = 12, 257
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    lg[::4] = np.round(lg[::4])
    temp = np.where(np.arange(B) % 3 == 0, 0.0,
                    rng.uniform(0.2, 2.0, B)).astype(np.float32)
    k = np.where(np.arange(B) % 2 == 0, 0,
                 rng.integers(1, 80, B)).astype(np.int32)
    p = np.where(np.arange(B) % 5 == 0, 1.0,
                 rng.uniform(0.3, 1.0, B)).astype(np.float32)
    got, want = _sample_both(_keys(B, seed), lg, temp, k, p)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), b=st.integers(1, 6))
def test_temperature_zero_is_argmax_bitwise(seed, b):
    lg = _tied_logits(b, 37, seed)
    z = np.zeros(b, np.float32)
    got, want = _sample_both(_keys(b, seed), lg, z, np.zeros(b, np.int32),
                             np.ones(b, np.float32))
    np.testing.assert_array_equal(got, np.argmax(lg, -1))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_sampling_params_validation_and_greedy():
    with pytest.raises(ValueError):
        ts.SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError):
        ts.SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        ts.SamplingParams(top_p=0.0)
    assert ts.GREEDY.greedy and not ts.SamplingParams(temperature=0.7).greedy
    assert ts.GREEDY == ts.SamplingParams()


@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jget("stablelm-3b").replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tget("stablelm-3b").replace(
        dtype="float32"), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("seed", [0, 5])
def test_generation_engine_sampled_matches_jax(lm_pair, seed):
    """``generate(greedy=False, seed)``: ``split`` then ``categorical``
    per step, the same tokens as the reference's engine (both on their
    default bf16 caches), and other tokens than greedy."""
    jcfg, params, model = lm_pair
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab, (3, 8)).astype(np.int32)
    want = jengine.GenerationEngine(jcfg, params, max_seq=32).generate(
        prompts, 10, greedy=False, seed=seed)
    eng = tengine.GenerationEngine(model.cfg, model, max_seq=32,
                                   device="cpu")
    got = eng.generate(prompts, 10, greedy=False, seed=seed)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.array_equal(got, eng.generate(prompts, 10))
