"""ResNet-18 and the callable backend against the JAX reference, on the
CPU.

The reference's ``resnet.init`` weights (100 classes, as its
``resnet_setup``), carried across by ``resnet_from_numpy`` (HWIO ->
OIHW); logits held to ``repro.models.resnet.forward`` at an even and an
odd image size, which take the two sides of XLA's ``"SAME"`` padding
(asymmetric at stride 2 on 64, symmetric on 33).  Budget: f32 with
other sum orders through 18 convolutions, within 1e-5 of the largest
|logit| (measured on an Intel Xeon CPU, PyTorch 2.13 against JAX 0.9:
9e-7).
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.models import convert, resnet  # noqa: E402
from repro_torch.serving import (PATH_DIRECT,  # noqa: E402
                                 CallableEngineAdapter, InferRequest,
                                 Server, ServerConfig)

REL_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    params = jax.jit(jresnet.init, static_argnames="n_classes")(
        jax.random.PRNGKey(1), n_classes=100)
    tree = jax.tree.map(np.asarray, params)
    return params, tree, convert.resnet_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("hw", [64, 33])
def test_resnet_logits_match_jax(pair, hw):
    params, _, model = pair
    x = np.random.default_rng(hw).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jresnet.forward)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 100)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_resnet_same_padding_is_xla_s():
    # stem 7x7/2 on 64 and 33, 3x3/2 on 16, the 1x1/2 projection, the pool
    assert resnet.same_pads(64, 7, 2) == (2, 3)
    assert resnet.same_pads(33, 7, 2) == (3, 3)
    assert resnet.same_pads(16, 3, 2) == (0, 1)
    assert resnet.same_pads(16, 1, 2) == (0, 0)
    assert resnet.same_pads(32, 3, 1) == (1, 1)


def test_resnet_converter_mismatch_raises(pair):
    _, tree, _ = pair
    flat = convert.flatten_tree(tree)
    missing = {k: v for k, v in flat.items() if k != "stages/1/0/proj"}
    with pytest.raises(ValueError, match="missing"):
        convert.resnet_from_numpy(missing, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.resnet_from_numpy(dict(flat, **{"stages/0/0/proj":
                                                flat["stages/1/0/proj"]}),
                                  device="cpu")
    bad = dict(flat, **{"stages/0/0/conv1": flat["stages/0/0/conv1"][:, :,
                                                                    :32]})
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.resnet_from_numpy(bad, device="cpu")


def test_callable_adapter_serves_resnet_on_the_direct_path(pair):
    """Every request answered once on the direct path with the model's
    own logits; the first call runs once more, untimed."""
    _, _, model = pair
    calls = []

    def fn(x):
        calls.append(1)
        return model(x)

    n = 6
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 1, 33, 33, 3)).astype(np.float32))
    port = CallableEngineAdapter(fn, name="resnet18", device="cpu")
    assert port.capabilities().paths == (PATH_DIRECT,)
    server = Server(port, ServerConfig(path="direct"))
    resp = server.serve([InferRequest(rid=i, arrival_s=0.25 * i,
                                      payload=imgs[i]) for i in range(n)])
    assert sorted(r.rid for r in resp) == list(range(n))
    assert len(calls) == n + 1
    with torch.inference_mode():
        for r in resp:
            assert r.path == PATH_DIRECT and r.admitted
            assert torch.equal(r.output, model(imgs[r.rid]))
            assert r.t_finish > r.t_start >= r.arrival_s
    assert server.summary()["n"] == n
