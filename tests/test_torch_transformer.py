"""The port's decoder LM against the reference, on the CPU.

The stablelm-3b smoke config (2 layers, d 128, 4 heads of 32, partial
rotary over 8 of 32 dims, LayerNorm, untied unembedding) in f32: params
from the reference's ``init_lm``, carried across with ``lm_from_numpy``.
``forward``, ``prefill`` and ``decode_step`` logits (scalar and [B]
positions) agree within 2e-4, the tolerance of ``tests/test_models.py``,
on the einsum path (``attn_impl="xla"``, the reference's ``"xla"``) and
on the kernels' plain versions (``"ref"`` on both sides), with the full
stack and with a ``window=4`` ring.  The caches there are f32: with the
default bf16 cache a 1e-7 difference in a projected key can round to
another bf16 value, which moves a logit by ~1e-3.  Greedy tokens use
the reference's own default, a bf16 cache on both sides, and are equal
on these seeded prompts.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

TOL = 2e-4
ARCH = "stablelm-3b"


def _configs(**kw):
    return (jget(ARCH).replace(dtype="float32", **kw),
            tget(ARCH).replace(dtype="float32", **kw))


@pytest.fixture(scope="module", params=[0, 4], ids=["full", "window4"])
def pair(request):
    jcfg, tcfg = _configs(window=request.param)
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, model


def _tokens(B, S, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - b.float().numpy()).max())


@pytest.mark.parametrize("impl", ["xla", "ref"])
def test_forward_prefill_decode_match_jax(pair, impl):
    jcfg, params, model = pair
    jcfg = jcfg.replace(attn_impl=impl)
    model.attn_impl = impl
    toks = _tokens(2, 11, jcfg.vocab)
    f1, _ = jtfm.forward(jcfg, params, jnp.asarray(toks))
    f2, aux = model.forward(toks)
    assert f2.shape == (2, 11, jcfg.vocab) and float(aux) == 0.0
    assert _err(f1, f2) < TOL
    c1 = jtfm.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    c2 = ttfm.init_cache(model.cfg, 2, 32, torch.float32, device="cpu")
    p1, c1 = jtfm.prefill(jcfg, params, jnp.asarray(toks[:, :8]), c1)
    p2, c2 = model.prefill(toks[:, :8], c2)
    assert p2.shape == (2, 1, jcfg.vocab) and _err(p1, p2) < TOL
    # the cache holds the same keys, values and positions
    assert _err(c1.layers.kv.k, c2.k) < TOL
    np.testing.assert_array_equal(np.asarray(c1.layers.kv.pos),
                                  c2.pos.numpy())
    # lockstep (scalar pos), then continuous ([B] pos, staggered)
    d1, c1 = jtfm.decode_step(jcfg, params, jnp.asarray(toks[:, 8:9]), c1, 8)
    d2, c2 = model.decode_step(toks[:, 8:9], c2, 8)
    assert _err(d1, d2) < TOL
    pos = np.array([9, 9], np.int32)
    d1, c1 = jtfm.decode_step(jcfg, params, jnp.asarray(toks[:, 9:10]), c1,
                              jnp.asarray(pos))
    d2, c2 = model.decode_step(toks[:, 9:10], c2, torch.from_numpy(pos))
    assert _err(d1, d2) < TOL
    np.testing.assert_array_equal(np.asarray(c1.layers.kv.pos),
                                  c2.pos.numpy())
    assert int(c2.length) == 10


def test_auto_on_cpu_is_bitwise_the_einsum_path(pair):
    """``attn_impl="auto"`` on a CPU tensor takes the model's own einsum
    path, bitwise equal to ``"xla"``, as the reference does off the TPU."""
    jcfg, _, model = pair
    toks = _tokens(2, 9, jcfg.vocab, seed=3)
    out = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        c = ttfm.init_cache(model.cfg, 2, 16, device="cpu")
        lp, c = model.prefill(toks[:, :8], c)
        ld, _ = model.decode_step(toks[:, 8:9], c, torch.tensor([8, 8]))
        out[impl] = (model.forward(toks)[0], lp, ld)
    for a, b in zip(out["auto"], out["xla"]):
        assert torch.equal(a, b)


def test_greedy_tokens_match_jax(pair):
    """Lockstep greedy generation, reference's default bf16 cache on
    both sides, equal tokens on seeded prompts."""
    jcfg, params, model = pair
    model.attn_impl = "auto"
    prompts = _tokens(3, 8, jcfg.vocab, seed=11)
    want = jengine.GenerationEngine(jcfg, params, max_seq=32).generate(
        prompts, 10)
    got = tengine.GenerationEngine(model.cfg, model, max_seq=32,
                                   device="cpu").generate(prompts, 10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    # sampled generation (held against the reference in
    # tests/test_torch_sampling.py) starts from the same argmax token
    sampled = tengine.GenerationEngine(model.cfg, model, max_seq=32,
                                       device="cpu").generate(
        prompts, 2, greedy=False)
    assert sampled.shape == (3, 2)
    np.testing.assert_array_equal(sampled[:, 0], got[:, 0])


@pytest.mark.parametrize("shape,positions", [
    ((2, 5, 4, 32), np.arange(5)),
    ((2, 5, 4, 32), np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])),
    ((2, 5, 32), np.arange(5) + 11),
])
@pytest.mark.parametrize("rd", [8, None])
def test_partial_rotary_matches_jax(shape, positions, rd):
    """Interleaved pairs over the first rd dims (stablelm: 25 % of 32),
    the rest passed through."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jnn.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                          10_000.0, rotary_dim=rd)
    got = tnn.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                         10_000.0, rotary_dim=rd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if rd:
        np.testing.assert_array_equal(got.numpy()[..., rd:], x[..., rd:])


def test_cache_write_ring_and_vector_start():
    """``cache_write`` in place: a scalar start into a ring keeps the
    last C tokens at position mod C; a [B] start writes each row at its
    own position."""
    c = tattn.init_kv_cache(2, 16, 1, 8, window=4, dtype=torch.float32)
    k = torch.arange(2 * 6 * 8, dtype=torch.float32).reshape(2, 6, 1, 8)
    out = tattn.cache_write(c, k, -k, 0)
    assert out is c
    assert c.pos.tolist() == [[4, 5, 2, 3]] * 2
    assert torch.equal(c.k[:, 0], k[:, 4]) and torch.equal(c.v[:, 1], -k[:, 5])
    tattn.cache_write(c, k[:, :1], k[:, :1], torch.tensor([6, 9]))
    assert c.pos.tolist() == [[4, 5, 6, 3], [4, 9, 2, 3]]
    assert torch.equal(c.k[1, 1], k[1, 0])


def test_lm_from_numpy_unstacks_and_raises_on_mismatch():
    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.asarray, jtfm.init_lm(jcfg, jax.random.PRNGKey(1)))
    flat = convert.flatten_tree(tree)
    assert flat["layers/mix/wq"].shape[0] == jcfg.n_layers
    per = convert.unstack_layers(flat, jcfg.n_layers)
    np.testing.assert_array_equal(per["layers/1/mix/wq"],
                                  flat["layers/mix/wq"][1])
    model = convert.lm_from_numpy(tcfg, tree, device="cpu")
    np.testing.assert_array_equal(model.layers[1].mlp.w_up.numpy(),
                                  flat["layers/mlp/w_up"][1])
    missing = {k: v for k, v in flat.items() if k != "unemb"}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_from_numpy(tcfg, missing, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.lm_from_numpy(tcfg, {**flat, "layers/mix/bq":
                                     flat["layers/mix/wq"][:, 0]},
                              device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.lm_from_numpy(tcfg, {**flat, "emb": flat["emb"][:5]},
                              device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        convert.lm_from_numpy(tcfg, {**flat, "layers/mix/wq":
                                     flat["layers/mix/wq"][:1]},
                              device="cpu")


def test_bf16_weights_carry_across_exactly():
    """bf16 params (the config's own dtype) keep their exact values."""
    jcfg = jget(ARCH)
    tree = jax.tree.map(np.asarray, jtfm.init_lm(jcfg, jax.random.PRNGKey(2)))
    model = convert.lm_from_numpy(tget(ARCH), tree, device="cpu")
    assert model.emb.dtype == torch.bfloat16
    assert model.layers[0].norm1.scale.dtype == torch.float32
    np.testing.assert_array_equal(model.emb.float().numpy(),
                                  np.asarray(tree["emb"], np.float32))


@pytest.mark.parametrize("arch,what", [
    ("recurrentgemma-2b", "rglru"), ("whisper-medium", "encoder-decoder"),
])
def test_other_families_raise_with_their_slice(arch, what):
    # the family builds; what it refuses is the reference's own: the
    # verify chunk on a stack that is not pure attention or is an
    # encoder-decoder
    other = ttfm.init_lm(tget(arch), 0, device="cpu")
    with pytest.raises(ValueError, match="decode_chunk needs a pure"):
        other.decode_chunk(np.zeros((1, 2), np.int32),
                           ttfm.init_cache(other.cfg, 1, 8, device="cpu"), 0)
    # the paged pool serves homogeneous full attention only
    paged_local = tget(ARCH).replace(kv_block_size=16, window=16)
    with pytest.raises(ValueError, match="paged KV pool"):
        ttfm.init_cache(paged_local, 2, 64, device="cpu")
    # the speculative verify: decode_chunk needs a cache, and a working
    # chunk's logits are the decode steps' at the same positions
    model = ttfm.init_lm(tget(ARCH), 0, device="cpu")
    with pytest.raises(ValueError, match="decode cache"):
        model.decode_chunk(np.zeros((1, 2), np.int32), None, 0)
    toks = _tokens(1, 6, model.cfg.vocab)
    caches = [ttfm.init_cache(model.cfg, 1, 8, torch.float32, device="cpu")
              for _ in range(2)]
    for c in caches:
        model.prefill(toks[:, :4], c)
    chunk, _ = model.decode_chunk(toks[:, 4:], caches[0], 4)
    steps = [model.decode_step(toks[:, 4 + j:5 + j], caches[1], 4 + j)[0]
             for j in range(2)]
    assert (chunk.float() - torch.cat(steps, 1).float()).abs().max() < TOL


def test_seeded_init_is_deterministic_and_finite():
    cfg = tget(ARCH)
    a = ttfm.init_lm(cfg, 5, device="cpu")
    b = ttfm.init_lm(cfg, 5, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    logits, _ = a.forward(_tokens(1, 6, cfg.vocab))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
