"""The port's int8 weight quantisation against the JAX reference's
(``repro.models.quant``), on the CPU.

On the reference's flat layout (``convert.lm_to_flat``, a homogeneous
stack's leaves ``[L, d_in, d_out]``) the port chooses the same leaves
and writes the same ``q`` and ``scale`` byte for byte; at a width where
each layer's matrix is under the 1 Mi-element floor but the stack of two
is not, so a per-layer quantisation would choose none of them.  The
reference's own checks hold on the port: the round-trip error bound,
the tree's selection, int8 decode logits within 0.15 of the largest and
top-1 agreement on half the rows or more, and the error report under
0.02; the port's int8 decode logits also equal the reference's int8
decode logits within 2e-4 (``tests/test_models.py``'s tolerance).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import quant  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

TOL = 2e-4
# d_ff 2048 at d 256: one layer's w_gate is 524,288 elements, the stack
# of 2 is 1 Mi, the floor
WIDE = dict(dtype="float32", d_model=256, d_ff=2048, vocab=8192)


@functools.lru_cache(maxsize=None)
def _pair(arch, **kw):
    jcfg = jget(arch).replace(**kw)
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tget(arch).replace(**kw),
                                  jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, model


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def test_quantize_tree_matches_jax_on_stacked_layout():
    _, params, model = _pair("stablelm-3b", **WIDE)
    jq = convert.flatten_tree(jax.tree.map(np.asarray, jquant.quantize_tree(
        params)))
    tq = quant.quantize_tree(convert.lm_to_flat(model))
    chosen = sorted(k for k, v in tq.items() if isinstance(v, dict))
    assert chosen == sorted({k.rsplit("/", 1)[0] for k in jq
                             if k.endswith("/q")})
    assert "layers/mlp/w_gate" in chosen and "emb" in chosen
    per_layer = [t for t in model.layers[0].mlp.parameters()]
    assert all(t.numel() < quant.MIN_QUANT_SIZE for t in per_layer)
    for k in chosen:
        assert tq[k]["q"].dtype == torch.int8
        assert np.array_equal(_bits(tq[k]["q"].numpy()), _bits(jq[k + "/q"]))
        assert np.array_equal(_bits(tq[k]["scale"].numpy()),
                              _bits(jq[k + "/scale"])), k
    for k, v in tq.items():
        if not isinstance(v, dict):
            assert np.array_equal(v.numpy(), jq[k])


@pytest.mark.parametrize("seed", range(6))
def test_quantize_roundtrip_error_bound(seed):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(2, 65, size=2)
    w = torch.from_numpy((rng.standard_normal((rows, cols))
                          * 10.0 ** rng.uniform(-3, 3)).astype(np.float32))
    d = quant.quantize(w)
    assert d["q"].dtype == torch.int8
    back = quant.dequantize(d, torch.float32)
    col_max = w.abs().amax(0) + 1e-9
    assert ((back - w).abs() <= col_max / 254 * 1.01 + 1e-6).all()
    jd = jquant.quantize(jnp.asarray(w.numpy()))
    assert np.array_equal(d["q"].numpy(), np.asarray(jd["q"]))


def test_quantize_tree_selects_large_matrices():
    params = {"big": torch.ones(1024, 1024), "small": torch.ones(4, 4),
              "vector": torch.ones(2 << 20)}
    qt = quant.quantize_tree(params)
    assert set(qt["big"]) == {"q", "scale"}
    assert qt["small"] is params["small"]
    assert qt["vector"] is params["vector"]
    back = quant.dequantize_tree(qt, torch.float32)
    np.testing.assert_allclose(back["big"].numpy(), np.ones((1024, 1024)),
                               rtol=1e-2)


def test_int8_decode_close_to_fp():
    """``tests/test_quant.py``'s decode check on the port, and the
    port's int8 logits against the reference's."""
    kw = dict(dtype="float32", remat=False, d_model=256, d_ff=512)
    jcfg, params, model = _pair("internlm2-20b", **kw)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0,
                                       jcfg.vocab))

    def decode(m):
        cache = ttfm.init_cache(m.cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
        m.prefill(toks[:, :8], cache)
        return m.decode_step(toks[:, 8:9], cache, 8)[0]

    ref = decode(model)
    qmodel = ttfm.LM(model.cfg, device="cpu")
    quant.load_dequantized(qmodel, quant.quantize_tree(
        convert.lm_to_flat(model)), torch.float32)
    out = decode(qmodel)
    assert (out - ref).abs().max() / (ref.abs().max() + 1e-9) < 0.15
    agree = (out[:, 0].argmax(-1) == ref[:, 0].argmax(-1)).float().mean()
    assert agree >= 0.5

    pq = jquant.dequantize_tree(jquant.quantize_tree(params), jnp.float32)
    jcache = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    _, jcache = jtfm.prefill(jcfg, pq, jnp.asarray(toks[:, :8]), jcache)
    jout, _ = jtfm.decode_step(jcfg, pq, jnp.asarray(toks[:, 8:9]), jcache, 8)
    assert np.abs(np.asarray(jout) - out.numpy()).max() < TOL


def test_quantization_error_report():
    _, params, model = _pair("stablelm-3b", **WIDE)
    report = quant.quantization_error(convert.lm_to_flat(model))
    jreport = jquant.quantization_error(params)
    assert report and set(report) == set(jreport)
    assert all(v < 0.02 for v in report.values())
    for k, v in jreport.items():
        assert report[k] == pytest.approx(v, rel=1e-6)
