"""The port's sharding specs (``repro_torch.launch.sharding`` and
``models.quant.quantize_specs``) against the JAX reference's
(``repro.launch.sharding``), on shape-only meshes, on the CPU.

Every arch in ``ARCH_IDS`` at published width: the port's meta model
(``abstract_lm``) in the reference's flat layout and one reference
``jax.eval_shape(init_lm)`` per arch, cached at module scope; on 16 x 16
and 2 x 16 x 16, with and without ``cfg`` and ``fsdp``, every leaf's
spec equals the reference's ``PartitionSpec`` as a tuple.  The caches
of every arch at batch 1 and 16, with ``seq_shard_kv`` off and on: a
homogeneous stack's leaves equal the reference's stacked specs, and a
mixed stack's per-kind stacks give, layer by layer, the reference's
per-layer specs after their lead None.  Then ``tokens_spec``,
``frontend_spec``, ``batch_spec_axis``, ``quantize_specs``, and the
reference's named invariants (``tests/test_sharding.py``) on the port.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jget  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tshd  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import quant as tquant  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (the specs read only .shape/.axis_names), the
    reference's ``tests/test_sharding.py:13-17``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESH = FakeMesh(data=16, model=16)
MESH_POD = FakeMesh(pod=2, data=16, model=16)
MESHES = {"16x16": MESH, "2x16x16": MESH_POD}


def _flat_specs(tree) -> dict:
    """A reference spec tree as {path without the lead '/': tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jshd._path_str(p)[1:]: tuple(s) for p, s in leaves}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget(arch)
    return cfg, jax.eval_shape(lambda: jtfm.init_lm(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = tget(arch)
    return cfg, convert.lm_flat(cfg, dict(ttfm.abstract_lm(cfg)
                                          .named_parameters()))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, jparams = _ref_params(arch)
    tcfg, tflat = _port_params(arch)
    for with_cfg in (False, True):
        for fsdp in (False, True):
            want = _flat_specs(jshd.param_specs(
                jparams, m, cfg=jcfg if with_cfg else None, fsdp=fsdp))
            got = tshd.param_specs(tflat, m, cfg=tcfg if with_cfg else None,
                                   fsdp=fsdp)
            assert got == want, (with_cfg, fsdp)


# a port cache leaf's reference path under a layer (``layers/<i>/...``
# in a mixed stack), and the kind of layer that holds it
_SUB = {n: p[len("/layers/"):] for n, p in tshd._CACHE_PATHS.items()
        if p.startswith("/layers/")}
_KIND = {"c_kv": "latent", "k_rope": "latent", "h": "ssd", "conv": "ssd",
         "lru_h": "rglru", "lru_conv": "rglru"}


@pytest.mark.parametrize("seq_shard_kv", [False, True])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, batch, seq_shard_kv):
    jcfg, tcfg = jget(arch), tget(arch)
    max_seq = 64
    jcache = jax.eval_shape(lambda: jtfm.init_cache(jcfg, batch, max_seq))
    want = _flat_specs(jshd.cache_specs(jcfg, jcache, MESH, batch,
                                        seq_shard_kv=seq_shard_kv))
    tcache = ttfm.abstract_cache(tcfg, batch, max_seq)
    got = tshd.cache_specs(tcfg, tcache, MESH, batch,
                           seq_shard_kv=seq_shard_kv)
    covered = set()
    for name, spec in got.items():
        if name in ("cross_k", "cross_v") or tcfg.homogeneous:
            path = tshd._CACHE_PATHS[name][1:]
            assert spec == want[path], name
            covered.add(path)
            continue
        layers = [i for i, (kind, _) in enumerate(tcache.index)
                  if kind == _KIND.get(name, "kv")]
        for i in layers:
            path = f"layers/{i}/{_SUB[name]}"
            assert spec[0] is None and spec[1:] == want[path], (name, i)
            covered.add(path)
    # every reference leaf with a spec has its counterpart
    assert {k for k, s in want.items() if s} <= covered


def test_tokens_frontend_and_batch_axis():
    for b in (1, 2, 16, 32, 256):
        for m in (MESH, MESH_POD):
            assert tshd.tokens_spec(m, b) == tuple(jshd.tokens_spec(m, b))
            assert tshd.frontend_spec(m, b) == tuple(
                jshd.frontend_spec(m, b))
            assert tshd.batch_spec_axis(m, b) == jshd.batch_spec_axis(m, b)
    assert tshd.tokens_spec(MESH_POD, 256) == (("pod", "data"), None)


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m"])
def test_quantize_specs_equal_reference(arch):
    jcfg, jparams = _ref_params(arch)
    tcfg, tflat = _port_params(arch)
    for fsdp in (False, True):
        jspec = jshd.param_specs(jparams, MESH, cfg=jcfg, fsdp=fsdp)
        want = _flat_specs(jquant.quantize_specs(jspec, jparams))
        got = tquant.quantize_specs(
            tshd.param_specs(tflat, MESH, cfg=tcfg, fsdp=fsdp), tflat)
        flat = {}
        for k, v in got.items():
            if isinstance(v, dict):
                flat[f"{k}/q"], flat[f"{k}/scale"] = v["q"], v["scale"]
            else:
                flat[k] = v
        assert flat == want
        assert any(isinstance(v, dict) for v in got.values())


def _specs(arch, **kw):
    cfg, flat = _port_params(arch)
    return tshd.param_specs(flat, MESH, **kw), flat


def _legal(arch):
    specs, flat = _specs(arch)
    for k, spec in specs.items():
        assert len(spec) <= flat[k].dim()
        used = [s for s in spec if s is not None]
        assert len(used) == len(set(used)), f"axis reuse at {k}"
        for d, ax in enumerate(spec):
            if ax == "model":
                assert flat[k].shape[d] % 16 == 0, (k, d)


def _non_divisible_heads_fall_back():
    cfg = tget("recurrentgemma-2b")
    specs, _ = _specs("recurrentgemma-2b", cfg=cfg)
    for w in ("wq", "wk", "wo"):
        assert "model" not in specs[f"layers/2/mix/{w}"]
    assert specs["layers/2/mlp/w_gate"][-1] == "model"


def _head_aligned_shards_when_divisible():
    specs, _ = _specs("internlm2-20b", cfg=tget("internlm2-20b"))
    assert specs["layers/mix/wq"][-1] == "model"
    assert specs["layers/mix/wo"][-2] == "model"
    assert "model" not in specs["layers/mix/wk"]


def _fsdp_adds_data_axis():
    specs, _ = _specs("llama3-405b", cfg=tget("llama3-405b"), fsdp=True)
    wq = specs["layers/mix/wq"]
    assert "model" in wq and "data" in wq
    used = [s for s in wq if s is not None]
    assert len(used) == len(set(used))


def _granite_expert_dim_falls_back_to_ffn():
    wg = _specs("granite-moe-3b-a800m")[0]["layers/moe/w_gate"]
    assert wg[1] is None and wg[-1] == "model"


def _dbrx_expert_dim_shards():
    assert _specs("dbrx-132b")[0]["layers/moe/w_gate"][1] == "model"


def _tokens_and_cache_specs():
    cfg = tget("internlm2-20b")
    assert tshd.tokens_spec(MESH, 256) == ("data", None)
    assert tshd.tokens_spec(MESH_POD, 256) == (("pod", "data"), None)
    assert tshd.tokens_spec(MESH, 1) == (None, None)
    k = tshd.cache_specs(cfg, ttfm.abstract_cache(cfg, 128, 1024), MESH,
                         128)["k"]
    assert k[1] == "data" and k[3] is None
    k1 = tshd.cache_specs(cfg, ttfm.abstract_cache(cfg, 1, 4096), MESH,
                          1)["k"]
    assert k1[1] is None and k1[2] == "data"


def _mla_cache_latent_spec():
    cfg = tget("minicpm3-4b")
    specs = tshd.cache_specs(cfg, ttfm.abstract_cache(cfg, 128, 512), MESH,
                             128)
    assert specs["c_kv"][1] == "data"


def _ssd_state_spec():
    cfg = tget("mamba2-780m")
    h = tshd.cache_specs(cfg, ttfm.abstract_cache(cfg, 128, 512), MESH,
                         128)["h"]
    assert h[1] == "data" and h[2] == "model"


INVARIANTS = {
    **{f"param_specs_legal[{a}]": functools.partial(_legal, a)
       for a in ARCH_IDS},
    "non_divisible_heads_fall_back": _non_divisible_heads_fall_back,
    "head_aligned_shards_when_divisible": _head_aligned_shards_when_divisible,
    "fsdp_adds_data_axis": _fsdp_adds_data_axis,
    "granite_expert_dim_falls_back_to_ffn":
        _granite_expert_dim_falls_back_to_ffn,
    "dbrx_expert_dim_shards": _dbrx_expert_dim_shards,
    "tokens_and_cache_specs": _tokens_and_cache_specs,
    "mla_cache_latent_spec": _mla_cache_latent_spec,
    "ssd_state_spec": _ssd_state_spec,
}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_reference_invariant_holds_on_port(name):
    INVARIANTS[name]()


def test_axis_helpers_read_stub_and_mesh_alike():
    assert tmesh.batch_axes(MESH_POD) == ("pod", "data")
    assert tmesh.batch_axis_size(MESH_POD) == 32
    assert tmesh.model_axis_size(MESH) == 16
    assert tmesh.model_axis_size(FakeMesh(data=4)) == 1


def test_paged_cache_and_stacked_axis_refused():
    cfg = tsmoke("stablelm-3b").replace(kv_block_size=8)
    paged = ttfm.init_cache(cfg, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tshd.cache_specs(cfg, paged, MESH, 2)
    with pytest.raises(ValueError, match="layers/mix/wq"):
        tshd.layer_spec(cfg, "layers.0.mix.wq",
                        {"layers/mix/wq": ("data", None, "model")})


def test_production_mesh_needs_its_ranks():
    """Without a group of 256 ranks the production mesh raises, naming
    the dry run, as the reference's does."""
    with pytest.raises(RuntimeError, match="launch/dryrun.py"):
        tmesh.make_production_mesh()
