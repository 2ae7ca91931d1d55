"""The port's DistilBERT and weight converter against the JAX reference,
on the CPU.

The reference's weights (``repro.models.distilbert.init``) are carried
across with ``distilbert_from_numpy``; the same numpy tokens go through
both encoders, in f32 on both sides (tolerance 1e-4: the two frameworks
sum the 64- and 128-wide contractions in other orders).
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import distilbert as jdb  # noqa: E402
from repro.training import checkpoint  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import distilbert as tdb  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402

TOL = 1e-4
# the launcher's small classifier (repro/launch/serve.py:126)
SMALL = dict(n_layers=3, d_model=64, n_heads=4, d_ff=128, vocab=600,
             max_pos=48)


@pytest.fixture(scope="module")
def pair():
    cfg = jdb.config(**SMALL)
    params = jdb.init(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = convert.distilbert_from_numpy(cfg, tree, device="cpu")
    return cfg, params, model


def _tokens(B=5, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (B, S),
                                                dtype=np.int32)


def _pad_mask(B=5, S=32, seed=1):
    lens = np.random.default_rng(seed).integers(4, S + 1, B)
    lens[0] = S
    return np.arange(S)[None, :] < lens[:, None]


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(pair, masked):
    cfg, params, model = pair
    toks = _tokens()
    mask = _pad_mask() if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    x = torch.from_numpy(toks).long()
    with torch.inference_mode():
        h = model.encode(x, tm).numpy()
        lg = model.logits(x, tm).numpy()
        ee = model.early_exit_logits(x, tm, exit_layer=1).numpy()
    np.testing.assert_allclose(
        h, np.asarray(jdb.encode(cfg, params, jnp.asarray(toks), jm)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lg, np.asarray(jdb.logits(cfg, params, jnp.asarray(toks), jm)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        ee, np.asarray(jdb.early_exit_logits(cfg, params, jnp.asarray(toks),
                                             jm, exit_layer=1)),
        rtol=TOL, atol=TOL)


def test_nn_pieces_match_jax():
    from repro.models import nn as jnn
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    got = tnn.layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                        torch.from_numpy(x)).numpy()
    want = jnn.layernorm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tnn.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.gelu(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


def test_seeded_init_is_reproducible_and_finite():
    cfg = tdb.config(**SMALL)
    a = tdb.init(cfg, seed=3, device="cpu")
    b = tdb.init(cfg, seed=3, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        assert bool(torch.isfinite(va).all()), k
    with torch.inference_mode():
        lg = a.logits(torch.from_numpy(_tokens()).long())
    assert lg.shape == (5, 2) and bool(torch.isfinite(lg).all())


def _flat_shapes(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(leaf.shape)
    return out


def test_full_width_keys_and_shapes_match_reference():
    """Every full-width reference weight has its counterpart, key for
    key and shape for shape; nothing is allocated (meta tensors and
    ``jax.eval_shape``)."""
    cfg = jdb.config()
    assert (cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["d_ff"],
            cfg["vocab"]) == (6, 768, 12, 3072, 30522)
    want = _flat_shapes(jax.eval_shape(lambda k: jdb.init(cfg, k),
                                       jax.random.PRNGKey(0)))
    assert tdb.config() == cfg
    model = tdb.DistilBERT(tdb.config(), device="meta")
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == want


def test_flat_npz_round_trip(pair, tmp_path):
    cfg, params, model = pair
    path = str(tmp_path / "distilbert.npz")
    checkpoint.save(path, params)
    flat = convert.load_flat_npz(path)
    loaded = convert.distilbert_from_numpy(cfg, flat, device="cpu")
    ref = dict(convert.flatten_tree(jax.tree.map(np.asarray, params)))
    for name, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[name.replace(".", "/")])
    x = torch.from_numpy(_tokens()).long()
    with torch.inference_mode():
        assert torch.equal(loaded.logits(x), model.logits(x))


def test_converter_raises_on_mismatch(pair):
    cfg, params, _ = pair
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    missing = {k: v for k, v in flat.items() if k != "cls_b"}
    with pytest.raises(ValueError, match="missing=.*cls_b"):
        convert.distilbert_from_numpy(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="extra=.*stray"):
        convert.distilbert_from_numpy(cfg, {**flat, "stray": flat["cls_b"]},
                                      device="cpu")
    bad = {**flat, "cls": flat["cls"].T}
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.distilbert_from_numpy(cfg, bad, device="cpu")
