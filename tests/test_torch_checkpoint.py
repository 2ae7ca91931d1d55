"""The port's checkpoints against the JAX reference's, on the CPU.

``repro_torch.training.checkpoint`` writes the reference's flat-npz
layout (``params/...`` with a homogeneous stack's layers stacked and a
mixed stack's per layer, ``opt/m/...``, ``opt/v/...``, ``opt/count``),
so a file written by either package loads into the other: the values
equal exactly (f32 here), the moments and count too.  A round trip
keeps each leaf's dtype (bf16 written as f32 and restored), and a
missing, extra or reshaped leaf raises ``ValueError``.
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
from repro.models import transformer as jtfm  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.training import AdamW, AdamWState  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402

ARCHS = ["stablelm-3b", "recurrentgemma-2b", "whisper-medium"]


def _grads(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's f32 params and AdamW state after one update on
    seeded gradients, as trees."""
    cfg = jget(arch).replace(dtype="float32")
    params = jtfm.init_lm(cfg, jax.random.PRNGKey(0))
    opt = JAdamW()
    grads = jax.tree.map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).standard_normal(
            p.shape).astype(np.float32)), params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return cfg, params, state


def _port_state(arch, seed, dtype="float32"):
    """A port model from ``seed`` and its AdamW state after one update
    on seeded gradients."""
    cfg = tget(arch).replace(dtype=dtype)
    model = ttfm.init_lm(cfg, seed, device="cpu")
    params = dict(model.named_parameters())
    opt = AdamW()
    grads = _grads({k: p.shape for k, p in params.items()}, seed)
    state, _ = opt.update_({k: torch.from_numpy(g).to(params[k].dtype)
                            for k, g in grads.items()},
                           opt.init(params), params)
    return model, state


def _flat(tree):
    return convert.flatten_tree(jax.tree.map(np.asarray, tree))


def _port_flat(model, state):
    return {"params": {k: t.numpy() for k, t in
                       convert.lm_to_flat(model).items()},
            "m": {k: t.numpy() for k, t in
                  convert.lm_flat(model.cfg, state.m).items()},
            "v": {k: t.numpy() for k, t in
                  convert.lm_flat(model.cfg, state.v).items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_loads_into_port(arch, tmp_path):
    _, params, state = _reference(arch)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, {"params": params, "opt": state})
    model, tstate = _port_state(arch, seed=5)
    out = checkpoint.load_into(path, {"params": model, "opt": tstate})
    assert out["params"] is model and isinstance(out["opt"], AdamWState)
    assert out["opt"].count == int(state.count) == 1
    got = _port_flat(model, out["opt"])
    for name, want in (("params", _flat(params)), ("m", _flat(state.m)),
                       ("v", _flat(state.v))):
        assert set(got[name]) == set(want)
        for k, w in want.items():
            assert np.array_equal(got[name][k], w), (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_into_reference(arch, tmp_path):
    _, params, state = _reference(arch)
    model, tstate = _port_state(arch, seed=0)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, {"params": model, "opt": tstate},
                    metadata={"arch": arch})
    back = jckpt.load_into(path, {"params": params, "opt": state})
    want = _port_flat(model, tstate)
    for name, tree in (("params", back["params"]), ("m", back["opt"].m),
                       ("v", back["opt"].v)):
        flat = _flat(tree)
        assert set(flat) == set(want[name])
        for k, w in want[name].items():
            assert np.array_equal(flat[k], w), (name, k)
    assert int(back["opt"].count) == tstate.count == 1


def test_roundtrip_keeps_dtypes(tmp_path):
    """A bf16 model with its f32 moments, a tensor, an int and a numpy
    array: saved, loaded into a second model built from another seed,
    equal byte for byte in their own dtypes."""
    model, state = _port_state("granite-moe-3b-a800m", seed=1,
                               dtype="bfloat16")
    extra = {"step": 7, "t": torch.arange(4, dtype=torch.int32),
             "a": np.linspace(0, 1, 3)}
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"p": model, "o": state, "x": extra},
                    metadata={"step": 3})
    model2, state2 = _port_state("granite-moe-3b-a800m", seed=2,
                                 dtype="bfloat16")
    template = {"step": 0, "t": torch.zeros(4, dtype=torch.int32),
                "a": np.zeros(3)}
    back = checkpoint.load_into(path, {"p": model2, "o": state2,
                                       "x": template})
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert any(t.dtype == torch.bfloat16 for t in model2.parameters())
    for k in state.m:
        assert torch.equal(state.m[k], back["o"].m[k])
        assert torch.equal(state.v[k], back["o"].v[k])
    assert back["o"].count == state.count
    assert back["x"]["step"] == 7 and torch.equal(back["x"]["t"], extra["t"])
    assert np.array_equal(back["x"]["a"], extra["a"])
    assert back["x"]["a"].dtype == extra["a"].dtype


def test_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        checkpoint.load_into(path, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_into(path, {"a": torch.ones(4)})
    model = ttfm.init_lm(tget("stablelm-3b"), 0, device="cpu")
    checkpoint.save(path, {"params": model})
    other = ttfm.init_lm(tget("stablelm-3b").replace(n_layers=3), 0,
                         device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_into(path, {"params": other})
