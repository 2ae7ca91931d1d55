"""The port's dry run (``repro_torch.launch.dryrun``) and the train
launcher's MFU against the JAX reference's, on the CPU.

``model_flops``, ``analytic_bytes_floor`` and ``pad_heads`` equal the
reference's for every (arch, shape) that ``applicable`` admits.  On the
fake process group (a subprocess: the group is per process), a smoke
dense config on a 1 x 4 mesh counts a quarter of the 1 x 1 mesh's
product flops per rank, within 10 %, in prefill and in decode: the model
axis really divides the work.  The stablelm ``decode_32k`` line on
the 256-rank production mesh prints ``1 ok`` within 30 s.  The train
launcher's MFU numerator is the reference's ``model_flops`` (6 x active
parameters x tokens), below 6 x every parameter for an MoE.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it
is imported, so the ``jdryrun`` fixture imports it with that variable
restored afterwards: no later JAX test in the worker sees it.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

from repro.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                           applicable, get_config as jget, get_shape,
                           get_smoke_config as jsmoke, shape_variant)
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.configs import shape_variant as tvariant  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture
def jdryrun(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as m
    return m


def _applicable():
    return [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
            if applicable(jget(a), get_shape(s))[0]]


def test_model_flops_floor_and_pad_heads_equal_reference(jdryrun):
    cases = _applicable()
    assert len(cases) == 39
    for arch, sname in cases:
        shape = get_shape(sname)
        jcfg = shape_variant(jget(arch), shape)
        tcfg = tvariant(tget(arch), shape)
        assert tdry.model_flops(tcfg, shape) == jdryrun.model_flops(
            jcfg, shape), (arch, sname)
        for n in (256, 512):
            assert tdry.analytic_bytes_floor(tcfg, shape, n) == \
                jdryrun.analytic_bytes_floor(jcfg, shape, n), (arch, sname)
        for tp in (4, 16):
            j, t = jdryrun.pad_heads(jcfg, tp), tdry.pad_heads(tcfg, tp)
            assert (t.n_heads, t.n_kv_heads) == (j.n_heads, j.n_kv_heads)


def test_train_mfu_counts_active_parameters(jdryrun):
    """granite's smoke config (4 experts, top 2): the launcher's MFU
    numerator is the reference's ``model_flops``, not 6 x every
    parameter."""
    jcfg, tcfg = jsmoke("granite-moe-3b-a800m"), tsmoke("granite-moe-3b-a800m")
    batch, seq = 8, 64
    shape = type(get_shape("train_4k"))("train", seq, batch, "train")
    got = ttrain.step_flops(tcfg, batch, seq)
    assert got == jdryrun.model_flops(jcfg, shape)
    every = sum(p.numel() for p in ttfm.abstract_lm(tcfg).parameters())
    assert got < 6 * every * batch * seq
    assert got == 6 * tcfg.n_active_params() * batch * seq


def _run(code: str, timeout: int = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_axis_divides_the_product_flops():
    code = textwrap.dedent("""
        import json, warnings
        warnings.filterwarnings("ignore")
        from repro_torch.configs import InputShape, get_smoke_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        cfg = get_smoke_config("stablelm-3b")
        out = {}
        for tp in (1, 4):
            with dryrun.fake_group(tp):
                mesh = make_host_mesh(data=1, model=tp, device_type="cpu")
                for mode in ("prefill", "decode"):
                    shape = InputShape(mode, 32, 2, mode)
                    out[f"{mode}{tp}"] = dryrun.exact_costs(cfg, shape,
                                                            mesh)[0]
        print(json.dumps(out))
    """)
    res = _run(code)
    for mode in ("prefill", "decode"):
        one, four = res[f"{mode}1"], res[f"{mode}4"]
        assert one > 0
        assert abs(4 * four / one - 1) < 0.10, (mode, one, four)


def test_production_mesh_takes_the_card_unless_asked():
    """On a full fake group the production mesh is on the card by
    default (raising here, without one) and on the host when asked."""
    code = textwrap.dedent("""
        import json
        import torch
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        with dryrun.fake_group(256):
            mesh = make_production_mesh(device_type="cpu")
            try:
                make_production_mesh()
                default = "built"
            except RuntimeError as e:
                default = str(e)
        print(json.dumps({"type": mesh.device_type, "shape": list(mesh.shape),
                          "names": list(mesh.mesh_dim_names),
                          "cuda": torch.cuda.is_available(),
                          "default": default}))
    """)
    res = _run(code)
    assert res["type"] == "cpu" and res["shape"] == [16, 16]
    assert res["names"] == ["data", "model"]
    if not res["cuda"]:
        assert "needs CUDA" in res["default"], res["default"]


@pytest.mark.slow
def test_production_mesh_decode_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-3b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: 1 ok, 0 skip, 0 fail" in out.stdout
    assert seconds <= 30, seconds
    rec = json.loads((tmp_path / "stablelm-3b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["flops_per_device"] > 0 and rec["collectives"]["count"] > 0
    assert rec["resharded"]["replicated_ops"] == {}
