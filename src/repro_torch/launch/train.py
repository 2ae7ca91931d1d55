"""Training launcher of the PyTorch port, ``repro.launch.train``'s: any
architecture, its smoke config by default and its published width with
``--full-config``, trained on ``lm_batches`` with the reference's AdamW
and cosine schedule, logged through ``Tracker`` and ``CarbonTracker``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch mamba2-780m --steps 50 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --full-config --steps 20 --batch 8 --seq 512     # on the card

Weights come from ``--seed`` (``models.transformer.init_lm``), on the
card by default (``--device cuda``, which raises without one).  A
prefix-LM's patch embeddings and an encoder-decoder's frame embeddings
are stubs, 0.02 x normal from ``torch.Generator`` seeds 2 and 1, the same
every step, as the reference draws them from fixed keys.  The train step
(``training.make_train_step``) differentiates the einsum and chunked
paths and remats each layer as the config says (the published configs:
``remat=True``, policy ``full``).  ``--checkpoint PATH`` writes
``{"params", "opt"}`` in the reference's flat layout at the end.

It prints each logged step's loss and, last, the reference's JSON
(``first_loss``, ``last_loss``, ``run_dir`` and the carbon report).  On
the card a line before it gives the card's name and power limit, the
median step ms (the first step apart), tokens per second, the peak of
``torch.cuda.max_memory_allocated`` and the model FLOPs utilisation:
6 x parameters x tokens per step over the step's time, against the
card's dense bf16 peak.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.models import transformer as tfm
from repro_torch.telemetry import CarbonTracker, Tracker
from repro_torch.training import AdamW, lm_batches, make_train_step
from repro_torch.training import checkpoint

# dense bf16 tensor-core peaks (NVIDIA data sheets), FLOP/s
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}


def card_label(device: torch.device) -> str:
    """``nvidia-smi``'s "name, power limit" of the card, the label every
    timed number carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def frontends(cfg, batch: int, device: torch.device) -> dict:
    """The stubbed encoder / patch embeddings the reference feeds."""
    out = {}
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(1)
        out["enc_embeds"] = 0.02 * torch.randn(
            batch, cfg.enc_seq, cfg.enc_d_model or cfg.d_model,
            generator=gen).to(device)
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(2)
        out["prefix_embeds"] = 0.02 * torch.randn(
            batch, cfg.n_patches, cfg.d_model, generator=gen).to(device)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--runs", default="runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def train(args: argparse.Namespace) -> dict:
    """Train as ``args`` say; -> {"result": the reference's summary,
    "losses": every step's loss, "perf": the card's numbers (None on the
    CPU)}."""
    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    tracker = Tracker(root=args.runs)
    run = tracker.start_run(f"train-{args.arch}")
    run.log_params(arch=args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, lr=args.lr, n_params=cfg.n_params(),
                   device=str(dev))
    carbon = CarbonTracker()

    model = tfm.init_lm(cfg, args.seed, device=dev)
    opt = AdamW(lr=args.lr)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt, total_steps=args.steps,
                           warmup=max(args.steps // 10, 1))
    gen = lm_batches(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                     seed=args.seed)
    stubs = frontends(cfg, args.batch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    carbon.start()
    losses, step_s = [], []
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(gen)).to(dev), **stubs}
        t0 = time.perf_counter()
        state, m = step(model, state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        loss = float(m["loss"])
        losses.append(loss)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            run.log_metrics(i, loss=loss, grad_norm=float(m["grad_norm"]))
            print(f"step {i:5d}  loss {loss:.4f}", flush=True)
    rep = carbon.stop(args.steps)

    if args.checkpoint:
        checkpoint.save(args.checkpoint, {"params": model, "opt": state},
                        metadata={"arch": args.arch, "steps": args.steps})
    run.log_artifact("carbon.json", rep)
    out_dir = run.finish()
    perf = None
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        med = statistics.median(step_s[1:] or step_s)
        tokens = args.batch * args.seq
        n_params = sum(p.numel() for p in model.parameters())
        peak = BF16_PEAK["pcie" if "pcie" in name.lower() else "sxm"]
        perf = {"card": card_label(dev), "arch": args.arch,
                "dtype": cfg.dtype,
                "remat": cfg.remat_policy if cfg.remat else "none",
                "batch": args.batch, "seq": args.seq,
                "tokens_per_step": tokens, "n_params": n_params,
                "first_step_ms": step_s[0] * 1e3, "step_ms_median": med * 1e3,
                "step_ms": [s * 1e3 for s in step_s],
                "tokens_per_s": tokens / med,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "mfu": 6 * n_params * tokens / med / peak,
                "mfu_peak_flops": peak}
    return {"result": {"first_loss": losses[0] if losses else None,
                       "last_loss": losses[-1] if losses else None,
                       "run_dir": out_dir, **rep},
            "losses": losses, "perf": perf}


def main(argv=None) -> dict:
    out = train(parser().parse_args(argv))
    if out["perf"] is not None:
        print(json.dumps({"train_perf": out["perf"]}), flush=True)
    print(json.dumps(out["result"], indent=2), flush=True)
    return out["result"]


if __name__ == "__main__":
    main()
