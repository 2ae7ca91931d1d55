"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (no JAX, nothing of ``repro``) and prints
one JSON object per line; any failed check raises, so the exit code is
not 0.  Phases:

  1. device  — the card's name, capability, power limit and idle power;
  2. build   — every CUDA kernel, built from ``src/repro_torch/kernels/csrc``
               (one ``nvcc`` per source, all at once), with the seconds taken;
  3. kernel  — each kernel on the card against its plain PyTorch version on
               the same inputs (f32 to 1e-4, bf16 to 3e-2, argmax exact, the
               first index winning ties), timed with CUDA events beside its
               bound and a one-call PyTorch yardstick: ``ms`` is device time
               (calls replayed from a CUDA graph), ``call_ms`` the time per
               call issued back to back from Python;
  4. serve   — the full-width DistilBERT with seeded weights through the
               launcher's ``serve_classifier`` on ``--path gated`` (bio
               controller, batch 64) and on ``--path auto``; each path runs
               with the launch counters zeroed just before and read just
               after, and must have launched every kernel of the path;
  5. parity  — the proxy entropy from the kernel against the plain version,
               and full-model logits on the card against the CPU (1e-3);
  6. breakdown — the gated step's parts at batch 64, timed on the card;
  7. kernels — one line with every kernel's numbers;
  8. the last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero without CUDA or without the repo.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.energy import energy_model_for  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import entropy as ent_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import distilbert  # noqa: E402
from repro_torch.serving.gated import make_gated_classify_step  # noqa: E402
from repro_torch.training.data import ClassificationData  # noqa: E402

F32_TOL = 1e-4          # tests/test_kernels.py:30
BF16_TOL = 3e-2
LOGITS_TOL = 1e-3       # CUDA vs CPU full model: other sum orders over d_ff
# published dense peaks (NVIDIA data sheets): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAKS = {"sxm": {"hbm": 3.35e12, "f32": 67e12},
         "pcie": {"hbm": 2.0e12, "f32": 51e12}}
ENTROPY_OPS_PER_ELEMENT = 6   # compare, subtract, exp, 2 mul-adds, add


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail_unless(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def _elapsed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the card's time, plus any gap in which it
    waited for the host to issue the next launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _elapsed_ms(lambda: [fn() for _ in range(iters)]) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, so the host's cost of issuing each call
    (Python, the wrapper's checks, the launch itself) is left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ms = _elapsed_ms(lambda: [g.replay() for _ in range(replays)])
    del g
    return ms / (replays * iters)


def entropy_bound_ms(B: int, V: int, itemsize: int, peaks: dict):
    """Least time for the work: inputs read once, outputs written once
    (f32 H, f32 p_max, i32 argmax), or its f32 operations at peak."""
    t_bytes = (B * V * itemsize + 12 * B) / peaks["hbm"]
    t_ops = ENTROPY_OPS_PER_ELEMENT * B * V / peaks["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    idle = nvidia_smi("power.draw")
    print(smi, flush=True)
    em = energy_model_for(name)
    emit(phase="device", name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         idle_power_draw=idle, assumed_idle_w=em.p_idle,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, p in paths.items():
        log = str(p) + ".log"
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = [ln.strip() for ln in f
                               if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=secs,
         libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
         ptxas=ptxas)


def _tied_rows(dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(6, 1000, generator=g, device=dev)
    x[0, [3, 700]] = 9.0          # tie across threads' strides
    x[1, [5, 5 + 256]] = 9.0      # tie inside one thread's stride
    x[2, [998, 999]] = 9.0        # tie at the ragged end
    x[3] = 0.5                    # uniform row: index 0 wins
    x[4, [0, 999]] = 9.0
    x[5, [31, 32]] = 9.0          # tie across two warps
    return x


def phase_kernel(peaks: dict):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [((1, 2), torch.float32), ((64, 2), torch.float32),
             ((128, 2), torch.float32), ((8, 2048), torch.bfloat16),
             ((64, 50304), torch.float32), ((8, 256000), torch.float32),
             ((16, 50257), torch.float32)]
    inputs = [(f"{B}x{V}", (torch.randn(B, V, generator=g, device=dev)
                            * 4).to(dt)) for (B, V), dt in cases]
    inputs.append(("tied_6x1000", _tied_rows(dev)))
    inputs.append(("tied_2x2", torch.tensor([[1.5, 1.5], [-2.0, -2.0]],
                                            device=dev)))
    max_err, main = 0.0, None
    for label, x in inputs:
        h, p, a = ops.entropy_stats(x, impl="cuda")
        hr, pr, ar = ent_mod.entropy_stats_plain(x)
        torch.cuda.synchronize()
        tol = F32_TOL if x.dtype == torch.float32 else BF16_TOL
        err = max((h - hr).abs().max().item(), (p - pr).abs().max().item())
        rel_ok = (torch.allclose(h, hr, rtol=tol, atol=tol)
                  and torch.allclose(p, pr, rtol=tol, atol=tol))
        fail_unless(rel_ok, f"entropy {label}: max abs err {err}")
        fail_unless(torch.equal(a, ar), f"entropy argmax {label}")
        fail_unless(bool(torch.isfinite(h).all() and torch.isfinite(p).all()),
                    f"entropy {label}: non-finite output")
        if label.startswith("tied"):
            first = (x == x.amax(-1, keepdim=True)).int().argmax(-1)
            fail_unless(torch.equal(a, first.to(torch.int32)),
                        f"{label}: first index must win a tie")
        max_err = max(max_err, err)
        B, V = x.shape
        iters = 200 if B * V < 1e6 else 20
        row = dict(phase="kernel", name="entropy_stats", shape=[B, V],
                   dtype=str(x.dtype).replace("torch.", ""), max_abs_err=err,
                   argmax_equal=True,
                   library_computes="entropy only (torch.distributions."
                                    "Categorical(logits).entropy())")
        fns = {"": lambda: ops.entropy_stats(x, impl="cuda"),
               "plain_": lambda: ent_mod.entropy_stats_plain(x),
               "library_": lambda: torch.distributions.Categorical(
                   logits=x, validate_args=False).entropy()}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = graph_ms(fn, iters)
            row[prefix + "call_ms"] = time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = entropy_bound_ms(
            B, V, x.element_size(), peaks)
        emit(**row)
        if label == "64x2":          # the gated path's [batch, n_classes]
            main = row
    return max_err, main


def _serve(path: str, extra: list[str]):
    args = serve.parser().parse_args(
        ["--device", "cuda", "--path", path, "--controller", "bio",
         "--runs", os.path.join(ROOT, "build", "chip_smoke_runs"), *extra])
    ent_mod.launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_classifier(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ent_mod.launches
    resp = server.responses
    fail_unless(len(resp) == args.requests
                and sorted(r.rid for r in resp) == list(range(args.requests)),
                f"{path}: every request answered once")
    fail_unless(all(r.output in (0, 1) for r in resp),
                f"{path}: every output a class id")
    ents = [r.telemetry["entropy"] for r in resp if "entropy" in r.telemetry]
    ents += [r.decision.L for r in resp if r.decision is not None]
    fail_unless(len(ents) > 0 and all(math.isfinite(e) for e in ents),
                f"{path}: finite entropies")
    fail_unless(all(math.isfinite(v) for v in summary.values()
                    if isinstance(v, float)), f"{path}: no NaN in summary")
    fail_unless(launches > 0, f"{path}: entropy kernel launched on the path")
    emit(phase="serve", seconds=secs,
         entropy_launches=launches, **summary)
    return launches


def phase_serve():
    return {
        "gated": _serve("gated", ["--max-batch", "64", "--requests", "256"]),
        "auto": _serve("auto", ["--requests", "300"]),
    }


def _gated_batch():
    """The full-width model and one gated batch (64 requests of 128
    tokens), as the launcher builds them."""
    cfg = distilbert.config()
    model = distilbert.init(cfg, seed=0, device="cuda")
    toks, _, _ = ClassificationData(vocab=cfg["vocab"], seq_len=128,
                                    seed=1).sample(64)
    return cfg, model, torch.from_numpy(toks).long().cuda()


def encoder_flops(cfg: dict, rows: int, seq: int, layers: int) -> int:
    """Multiply-adds x 2 of ``layers`` encoder layers over rows x seq
    tokens: the q/k/v/o and MLP products plus the scores and the
    weighted sum of attention."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return rows * seq * layers * (2 * (4 * d * d + 2 * d * f) + 4 * seq * d)


def phase_breakdown(cfg, model, x, peaks: dict):
    """Where the gated step's device time goes at batch 64: the proxy
    (one layer over the batch), the entropy kernel, the full model over
    the 32-row bucket, and the whole step, beside the f32 bound of the
    encoder's products (TF32 is off, so they run on the f32 units)."""
    B, S = x.shape
    cap = B // 2
    step = make_gated_classify_step(cfg, exit_layer=1, device="cuda")
    flops = (encoder_flops(cfg, B, S, 1)
             + encoder_flops(cfg, cap, S, cfg["n_layers"]))
    with torch.inference_mode():
        lg = model.early_exit_logits(x, exit_layer=1)
        emit(phase="breakdown", batch=B, bucket=cap, seq=S,
             proxy_ms=time_ms(lambda: model.early_exit_logits(
                 x, exit_layer=1), 10),
             entropy_ms=graph_ms(lambda: ops.entropy_stats(lg), 50),
             full_bucket_ms=time_ms(lambda: model.logits(x[:cap]), 10),
             step_ms=time_ms(lambda: step(model, x, 0.5, 0.5, 0.0, B), 10),
             encoder_gflop=flops / 1e9,
             encoder_f32_bound_ms=flops / peaks["f32"] * 1e3)


def phase_parity(cfg, model, x):
    # the proxy entropy from the kernel vs the plain version, same logits
    with torch.inference_mode():
        lg = model.early_exit_logits(x, exit_layer=1)
        h, p, a = ops.entropy_stats(lg, impl="cuda")
        hr, pr, ar = ops.entropy_stats(lg, impl="ref")
        proxy_err = max((h - hr).abs().max().item(),
                        (p - pr).abs().max().item())
        fail_unless(proxy_err <= F32_TOL and torch.equal(a, ar),
                    f"proxy entropy kernel vs ref: {proxy_err}")
        # the full model on the card vs the same weights on the CPU
        full = model.logits(x[:4]).cpu()
        cpu_model = distilbert.DistilBERT(cfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        full_cpu = cpu_model.logits(x[:4].cpu())
    logits_err = (full - full_cpu).abs().max().item()
    fail_unless(bool(torch.isfinite(full).all()) and logits_err <= LOGITS_TOL,
                f"full logits CUDA vs CPU: {logits_err}")
    emit(phase="parity", proxy_entropy_max_abs_err=proxy_err,
         full_logits_cuda_vs_cpu_max_abs_err=logits_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    name, _ = phase_device()
    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    phase_build()
    max_err, main_row = phase_kernel(peaks)
    launches = phase_serve()
    cfg, model, x = _gated_batch()
    phase_parity(cfg, model, x)
    phase_breakdown(cfg, model, x, peaks)
    emit(kernels=[{
        "name": "entropy_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/entropy.py:29",
        "tpu_kernel": "src/repro/kernels/entropy.py:_entropy_kernel",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "shape": main_row["shape"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_computes": main_row["library_computes"],
        "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "library_call_ms": main_row["library_call_ms"],
    }])
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
