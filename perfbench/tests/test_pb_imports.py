"""No module a run imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro``: names are compared whole, before the first dot,
so the port's ``repro_torch`` passes."""
import subprocess
import sys
from pathlib import Path

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.serving", "jaxtyping", "reprox",
                 "perfbench.lib.bench"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert name not in run.forbidden_modules() or name in {
            n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "repro.serving.engine", sys)
    assert "repro" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"jax", "repro"} <= set(run.forbidden_modules())


def test_harness_and_port_load_no_forbidden_module():
    """A fresh interpreter that imports everything a run imports, and runs
    a cell's program path on the CPU, loads none of them."""
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "from perfbench import run, control\n"
        "from perfbench.lib import bench, nvml, profile, readers\n"
        "from perfbench.reference import control as c, lm\n"
        "import repro_torch.serving.continuous, repro_torch.models.transformer\n"
        "for p in (run.HERE / 'metrics').glob('*.py'): run.load_reader(p.stem)\n"
        "print(json.dumps(run.forbidden_modules()))\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "stablelm-3b.decode-backlog", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
