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

from port_threads import share_cores  # noqa: E402

share_cores()

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert, distilbert, resnet, ssd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import continuous, engine, gated  # noqa: E402
from repro_torch.serving.adapters import (  # noqa: E402
    CallableEngineAdapter, GatedEngineAdapter)
from repro_torch.training import (ClassificationData,  # noqa: E402
                                  train_classifier)

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
    assert int(n) >= 61                       # every module was imported
    assert bad.strip() == "[]"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = distilbert.config(**SMALL)
    model = distilbert.init(cfg, seed=0, device="cpu")
    tree = {k.replace(".", "/"): v.numpy()
            for k, v in model.state_dict().items()}
    rtree = {k.replace(".", "/"): v.numpy().transpose(2, 3, 1, 0)
             if v.dim() == 4 else v.numpy() for k, v in
             resnet.init(10, device="cpu").state_dict().items()}
    # no batch is drawn: the trainer resolves its device first
    batches = iter(())
    calls = [
        lambda: distilbert.init(cfg),
        lambda: convert.distilbert_from_numpy(cfg, tree),
        lambda: engine.ClassifierEngine(cfg, model),
        lambda: gated.make_gated_classify_step(cfg),
        lambda: gated.serve_gated(cfg, model, np.zeros((2, 4), np.int32),
                                  tau_schedule=lambda t: 0.5),
        lambda: GatedEngineAdapter(cfg, model),
        lambda: tserve.serve_classifier(tserve.parser().parse_args([])),
        lambda: tserve.serve_classifier(tserve.parser().parse_args(
            ["--full-width"])),
        lambda: tserve.build_classifier(),
        lambda: train_classifier(model, batches, steps=1),
        lambda: resnet.init(),
        lambda: convert.resnet_from_numpy(rtree),
        lambda: CallableEngineAdapter(lambda x: x),
    ]
    lm_cfg = get_smoke_config("stablelm-3b")
    lm = tfm.init_lm(lm_cfg, 0, device="cpu")
    lm_tree = {k.replace(".", "/"): v.float().numpy()
               for k, v in lm.state_dict().items()}
    gen_args = tserve.parser().parse_args(["--mode", "generate", "--smoke"])
    paged_args = tserve.parser().parse_args(
        ["--mode", "generate", "--smoke", "--kv-block-size", "8"])
    paged_cfg = lm_cfg.replace(kv_block_size=8)
    ssm_cfg = get_smoke_config("mamba2-780m")
    ssm = tfm.init_lm(ssm_cfg, 0, device="cpu")
    ssm_tree = {k.replace(".", "/"): v.float().numpy()
                for k, v in ssm.state_dict().items()}
    ssm_args = tserve.parser().parse_args(
        ["--mode", "generate", "--smoke", "--arch", "mamba2-780m"])
    calls += [
        lambda: tfm.init_lm(lm_cfg),
        lambda: tfm.init_cache(lm_cfg, 2, 16),
        lambda: tfm.init_cache(lm_cfg, 2, 16, layout="paged"),
        lambda: convert.lm_from_numpy(lm_cfg, lm_tree),
        lambda: engine.GenerationEngine(lm_cfg, lm),
        lambda: continuous.ContinuousBatchingEngine(lm_cfg, lm),
        lambda: continuous.ContinuousBatchingEngine(paged_cfg, lm),
        lambda: tserve.serve_generate(gen_args),
        lambda: tserve.serve_generate(paged_args),
        lambda: tfm.init_lm(ssm_cfg),
        lambda: tfm.init_cache(ssm_cfg, 2, 16),
        lambda: ssd.init_ssd_state(2, 128, expand=2, headdim=32, d_state=16,
                                   conv_width=4),
        lambda: convert.lm_from_numpy(ssm_cfg, ssm_tree),
        lambda: engine.GenerationEngine(ssm_cfg, ssm),
        lambda: continuous.ContinuousBatchingEngine(ssm_cfg, ssm),
        lambda: tserve.serve_generate(ssm_args),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            call()
    assert tserve.parser().parse_args([]).device == "cuda"
    assert gen_args.device == "cuda" and gen_args.attn_impl == "auto"
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.entropy_stats(x, impl="cuda")
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.decode_attention(q[:, :, 0], q, q,
                             torch.zeros(1, 4, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), impl="cuda")
    for impl in ("cuda", "shim"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.paged_decode_attention(
                q[:, :, 0], q, q, torch.zeros(1, 2, dtype=torch.int32),
                torch.zeros(1, 4, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32), impl=impl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd_scan(q, q[..., 0], q[0, :, 0, 0], q[..., 0], q[..., 0],
                     impl="cuda")
    # the CPU runs only when asked for
    assert engine.ClassifierEngine(cfg, model,
                                   device="cpu").device.type == "cpu"
    assert continuous.ContinuousBatchingEngine(
        lm_cfg, lm, device="cpu").device.type == "cpu"
    assert continuous.ContinuousBatchingEngine(
        paged_cfg, lm, device="cpu").paged


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


@pytest.mark.parametrize("script", ["entropy_compare.py",
                                    "attention_compare.py"])
def test_compare_scripts_need_a_card(script):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / script)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
