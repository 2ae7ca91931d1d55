"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``perfbench/configs/<name>.json``, which names the module that
describes its model: ``perfbench/lib/describe.py``) and a traffic mix
(``perfbench/traffic/<name>.json``); its limits are
``perfbench/checks/<cell>.json`` and each metric is read by
``perfbench/metrics/<metric>.py``.  With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
The last line of standard output is one JSON object; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the last key of that object.  Without a CUDA device
it exits with 2 and prints no result.
"""
import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s scale (Linux: from
    ``/proc``; elsewhere the first line of this file)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return T_IMPORT - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    keep ``transformers`` (should anything load it) off flax."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compute


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_files(manifest: dict, cell_name: str) -> tuple[dict, dict, dict, dict]:
    cell = next((w for w in manifest["workloads"] if w["name"] == cell_name), None)
    if cell is None:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    model_file = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "checks" / f"{cell_name}.json")
    return cell, model_file, mix, limits


def result_line(rec: dict, chosen: list[dict], device: dict) -> dict:
    metrics = {}
    for m in chosen:
        v = load_reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if rec.get("trace"):
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = rec["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    set_cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, model_file, mix, limits = cell_files(manifest, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from perfbench.lib import bench, nvml
    energy = nvml.EnergyCounter(0)
    rec = bench.run_cell(cell, model_file, mix, limits, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device="cuda", energy=energy, t_start=t_start)
    # beside the peak: the K/V the slots reserve at max_seq, and the part
    # of it that held live rows, on average over the window
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"]),
              "kv_pool_bytes": int(rec["kv_bytes"]["pool"]),
              "kv_live_bytes": int(rec["kv_bytes"]["live"])}
    if args.trace:
        device.update(busy_s=rec["trace"]["busy_s"],
                      window_s=rec["trace"]["window_s"])
    line = result_line(rec, metrics_of(manifest, cell["name"], bool(args.trace)),
                       device)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark forbids: {bad}", file=sys.stderr)
        return 3
    print(f"card: {device['kind']}, power limit {energy.power_limit_w():.2f} W; "
          f"window {rec['window_s']:.3f} s, tokens compared "
          f"{rec['tokens_compared']}; memory peak {device['memory_peak_bytes']} B, "
          f"K/V pool {device['kv_pool_bytes']} B, live {device['kv_live_bytes']} B",
          file=sys.stderr)
    print("phases: " + json.dumps({k: round(v, 3) for k, v in rec["phases"].items()})
          + f"; window halves, tokens/s: {rec['half_rates']}; work: {rec['work']}; "
          f"counters: {rec['counters']}; worst gap at: {rec['worst']}", file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
