"""The port's boundaries: it imports no JAX and nothing of ``repro``; its
entry points default to the card and refuse to run without one; and
``chip_smoke.py`` fails, printing no result, where there is no card or
no repo.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert, distilbert  # noqa: E402
from repro_torch.serving import engine, gated  # noqa: E402
from repro_torch.serving.adapters import GatedEngineAdapter  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_layers=1, d_model=16, n_heads=2, d_ff=32, vocab=50,
             max_pos=8)

_HYGIENE = """
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[2])
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run(
        [sys.executable, "-c", _HYGIENE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=120, env=_env(), check=True)
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 30                       # every module was imported
    assert bad.strip() == "[]"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = distilbert.config(**SMALL)
    model = distilbert.init(cfg, seed=0, device="cpu")
    tree = {k.replace(".", "/"): v.numpy()
            for k, v in model.state_dict().items()}
    calls = [
        lambda: distilbert.init(cfg),
        lambda: convert.distilbert_from_numpy(cfg, tree),
        lambda: engine.ClassifierEngine(cfg, model),
        lambda: gated.make_gated_classify_step(cfg),
        lambda: gated.serve_gated(cfg, model, np.zeros((2, 4), np.int32),
                                  tau_schedule=lambda t: 0.5),
        lambda: GatedEngineAdapter(cfg, model),
        lambda: tserve.serve_classifier(tserve.parser().parse_args([])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            call()
    assert tserve.parser().parse_args([]).device == "cuda"
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.entropy_stats(x, impl="cuda")
    # the CPU runs only when asked for
    assert engine.ClassifierEngine(cfg, model,
                                   device="cpu").device.type == "cpu"


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even on a GPU box
    here = _run_smoke(ROOT, env)
    assert here.returncode != 0
    assert '"ok"' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path, env)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
