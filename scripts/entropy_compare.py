"""Time the entropy kernel of one source tree at chip_smoke.py's cases.

    python3 scripts/entropy_compare.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), builds that tree's ``csrc/entropy.cu`` into the tree's own
``build/`` directory, holds the kernel against its plain version on
every entropy case of ``chip_smoke.py`` (the same inputs, the same
tolerances) and prints one JSON line per case: the kernel's device time
(``ms``: calls replayed from a CUDA graph) and its time per call issued
from Python (``call_ms``), as ``chip_smoke.py`` times them.  To compare
two trees, unpack the other one (``git archive``) into a directory git
ignores and run both in one command on one card, in turns:

    python3 scripts/entropy_compare.py --src build/parent/src --label parent
    python3 scripts/entropy_compare.py --label change

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="", help="printed on every line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("entropy_compare: needs a CUDA card", file=sys.stderr)
        return 1
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, os.path.abspath(args.src))
    ent_mod = importlib.import_module("repro_torch.kernels.entropy")
    sys.path.insert(1, ROOT)
    import chip_smoke as smoke
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    dev = torch.device("cuda")
    schedule = getattr(ent_mod, "entropy_schedule", None)
    tie_splits = smoke.TIE_SPLITS
    if schedule is not None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tie_splits = schedule(8, 256000, 4, sms)["splits"]
    for label, x in smoke.entropy_inputs(dev, tie_splits):
        err = smoke.check_entropy(label, x, ent_mod.entropy_stats_cuda(x))
        B, V = x.shape
        iters = 200 if B * V < 1e6 else 20
        fn = (lambda: ent_mod.entropy_stats_cuda(x))
        print(json.dumps({
            "tree": args.label, "source": os.path.relpath(ent_mod.__file__,
                                                          ROOT),
            "case": label, "shape": [B, V],
            "dtype": str(x.dtype).replace("torch.", ""), "max_abs_err": err,
            "ms": smoke.graph_ms(fn, iters),
            "call_ms": smoke.time_ms(fn, iters), "nvidia_smi": smi}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
