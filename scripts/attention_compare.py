"""Time the attention kernels of one source tree at chip_smoke.py's cases.

    python3 scripts/attention_compare.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), builds that tree's ``csrc/flash_attention.cu`` and
``csrc/decode_attention.cu`` into the tree's own ``build/`` directory,
and on the attention cases of ``chip_smoke.py`` at hd 256 (the
recurrentgemma-2b and paligemma-3b rows, and paligemma's verify chunk)
and at the main shapes (stablelm-3b's prefill, decode and paged decode;
one user's 8192-row context) holds each kernel against its plain version
(the same inputs and tolerances as ``chip_smoke.py``) and prints one
JSON line per case: the kernel's device time (``ms``: calls replayed
from a CUDA graph), its error and the card.  To compare two trees,
unpack the other one (``git archive``) into a directory git ignores and
run both in one command on one card, in turns:

    python3 scripts/attention_compare.py --src build/parent/src --label parent
    python3 scripts/attention_compare.py --label change

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
MAIN_CASES = ("prefill_main", "decode_main_bf16q", "paged_main",
              "decode_long_b1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="", help="printed on every line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_compare: needs a CUDA card", file=sys.stderr)
        return 1
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, os.path.abspath(args.src))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    sys.path.insert(1, ROOT)
    import chip_smoke as smoke
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in smoke.ATTN_CASES:
        if case["hd"] != 256 and case["name"] not in MAIN_CASES:
            continue
        kind, B, H, K, S, hd = (case[k] for k in ("kind", "B", "H", "K",
                                                  "S", "hd"))
        w = case["window"]
        if kind == "flash":
            q, k, v = (smoke._bshd_views((B, X, S, hd), case[dt], gen)
                       for X, dt in ((H, "qdt"), (K, "kvdt"), (K, "kvdt")))
            kern = lambda: fa.flash_attention_cuda(q, k, v,  # noqa: E731
                                                   window=w)
            want = fa.flash_attention_plain(q, k, v, window=w)
        elif kind == "paged":
            q, kp, vp, tbl, kv_pos, cur = smoke._paged_inputs(case, gen)
            kern = lambda: da.paged_decode_attention_cuda(  # noqa: E731
                q, kp, vp, tbl, kv_pos, cur, window=w)
            want = da.paged_decode_attention_plain(q, kp, vp, tbl, kv_pos,
                                                   cur, window=w)
        else:
            q = torch.randn(B, H, hd, generator=gen,
                            device="cuda").to(case["qdt"])
            k, v = (smoke._bshd_views((B, K, S, hd), case["kvdt"], gen)
                    for _ in range(2))
            kv_pos, cur = smoke._decode_positions(B, S, case["lengths"],
                                                  case["ring"])
            kern = lambda: da.decode_attention_cuda(  # noqa: E731
                q, k, v, kv_pos, cur, window=w)
            want = da.decode_attention_plain(q, k, v, kv_pos, cur, window=w)
        got = kern()
        torch.cuda.synchronize()
        err = smoke.row_scaled_error(got, want)
        smoke.fail_unless(err <= smoke.ATTN_BF16_ROW_TOL,
                          f"{case['name']}: row-scaled err {err}")
        print(json.dumps(dict(label=args.label, case=case["name"], hd=hd,
                              ms=smoke.graph_ms(kern, case["iters"]),
                              row_scaled_err=err, card=smi)), flush=True)
    for name, dt, B, n, S, lengths, heads in smoke.SPEC_CHUNK_CASES:
        if heads[2] != 256:
            continue
        q, k, v, kv_pos, start = smoke._chunk_inputs(dt, B, n, S, lengths,
                                                     gen, heads)
        kern = lambda: da.decode_attention_chunk_cuda(  # noqa: E731
            q, k, v, kv_pos, start)
        got = kern()
        want = da.decode_attention_chunk_plain(q, k, v, kv_pos, start)
        torch.cuda.synchronize()
        err = smoke.row_scaled_error(got, want)
        smoke.fail_unless(err <= smoke.ATTN_BF16_ROW_TOL,
                          f"chunk {name}: row-scaled err {err}")
        print(json.dumps(dict(label=args.label, case=f"chunk_{name}",
                              hd=heads[2], ms=smoke.graph_ms(kern, 200),
                              row_scaled_err=err, card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
