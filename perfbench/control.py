"""Readings for the limits of a cell's correctness check, on the card:
for each seed, one run of the cell at its own load with a short window
(the program's readings, as every run makes them), then the control's
readings on the same served requests (``reference/control.py``).

    python3 perfbench/control.py --workload <cell> --seconds 8 --seeds 1 2 3

Prints one JSON line per seed and, last, the largest program reading
and the smallest control reading of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import run  # noqa: E402


def readings(cell_name: str, seeds, seconds: float, *, device="cuda",
             energy=None, control: bool = True) -> list[dict]:
    import torch
    from perfbench.lib import bench
    from perfbench.reference import control as ctl
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, model_file, mix, limits = run.cell_files(manifest, cell_name)
    if energy is None:
        from perfbench.lib import nvml
        energy = nvml.EnergyCounter(0)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        rec = bench.run_cell(cell, model_file, mix, limits, seed=seed,
                             seconds=seconds, trace=False, device=device,
                             energy=energy, t_start=t)
        row = {"seed": seed, "correct": rec["correct"],
               "program": rec["readings"], "worst": rec["worst"],
               "tokens_compared": rec["tokens_compared"],
               "phases": rec["phases"], "half_rates": rec["half_rates"],
               "memory_peak_bytes": rec["memory_peak_bytes"],
               "kv_bytes": rec["kv_bytes"]}
        if control:
            row["control"] = ctl.control_readings(rec["ref"], model_file["model"],
                                                  seed, rec["served"], device)
        row["seconds"] = time.perf_counter() - t
        out.append(row)
        print(json.dumps(row), flush=True)
        del rec
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args()
    run.set_cache_dirs()
    rows = readings(args.workload, args.seeds, args.seconds,
                    control=not args.no_control)
    summary = {"lower": {}, "control_min": {}}
    for r in rows:
        for k, v in r["program"].items():
            summary["lower"][k] = max(v, summary["lower"].get(k, v))
        for k, v in r.get("control", {}).items():
            summary["control_min"][k] = min(v, summary["control_min"].get(k, v))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
