"""Schema-validate exported observability artifacts (CI gate).

Usage::

    python -m repro_torch.telemetry.validate TRACE.json [METRICS.json]
        [--require-gauge NAME ...] [--require-counter NAME ...]

Fails (exit 1) on orphan spans, negative durations, per-resource
overlap, unbalanced async pairs, a malformed metrics snapshot, or a
missing required gauge/counter.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from .trace import validate_chrome

__all__ = ["validate_metrics_snapshot", "main"]


def validate_metrics_snapshot(doc: Dict[str, Any], require_gauges: List[str] = (),
                              require_counters: List[str] = ()) -> List[str]:
    problems: List[str] = []
    for section in ("counters", "gauges", "histograms"):
        if section not in doc or not isinstance(doc[section], dict):
            problems.append(f"metrics snapshot missing section {section!r}")
    gauges = doc.get("gauges", {})
    for name in require_gauges:
        series = gauges.get(name)
        if not series:
            problems.append(f"required gauge {name!r} absent or empty")
    counters = doc.get("counters", {})
    for name in require_counters:
        series = counters.get(name)
        if not series:
            problems.append(f"required counter {name!r} absent or empty")
    for name, series in (doc.get("counters", {}) or {}).items():
        for s in series:
            if s.get("value", 0.0) < 0.0:
                problems.append(f"negative counter {name}{s.get('labels')}")
    return problems


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace-event JSON to validate")
    ap.add_argument("metrics", nargs="?", help="metrics snapshot JSON to validate")
    ap.add_argument(
        "--require-gauge",
        nargs="*",
        default=[],
        help="gauge names that must exist non-empty in the metrics snapshot",
    )
    ap.add_argument(
        "--require-counter",
        nargs="*",
        default=[],
        help="counter names that must exist non-empty in the metrics snapshot",
    )
    args = ap.parse_args(argv)

    problems: List[str] = []
    with open(args.trace) as f:
        trace_doc = json.load(f)
    problems += validate_chrome(trace_doc)
    n_events = len(trace_doc.get("traceEvents", []))

    if args.metrics:
        with open(args.metrics) as f:
            metrics_doc = json.load(f)
        problems += validate_metrics_snapshot(metrics_doc, args.require_gauge,
                                              args.require_counter)

    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"ok: {n_events} trace events" + (", metrics snapshot valid" if args.metrics else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
