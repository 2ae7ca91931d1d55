"""The reduction from a ``torch.profiler`` trace (CUPTI) to what the
per-layer metrics read: every device operation's interval, the device's
busy time (the union of those intervals), the time by operation name,
and the idle gaps named by what the host was doing in them.  The host
side is named by the benchmark's own ``record_function`` spans (``pb.``
and a phase) and the innermost operation the profiler saw the host in.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SPAN = "pb."
WINDOW = "measured window"
SMALL_GAP_US = 50.0


def _device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def reduce(events, window_s: float) -> dict:
    """``events``: the profiler's ``events()``; only what starts inside the
    benchmark's window span counts, where the trace holds one.  ->
    ``busy_s``, ``window_s``, ``kernel_s`` (seconds by operation name),
    ``device_ops`` and ``idle_gaps`` (the ten largest, ``[name,
    seconds]``)."""
    events = list(events)
    win = next(((e.time_range.start, e.time_range.end) for e in events
                if e.name == SPAN + WINDOW and not _device(e)), None)
    dev, host, spans = [], [], []
    for e in events:
        tr = e.time_range
        if win is not None and not win[0] <= tr.start <= win[1]:
            continue
        if e.name.startswith(SPAN):
            # the device-side copy of a benchmark span is no device work
            if not _device(e) and e.name != SPAN + WINDOW:
                spans.append((tr.start, tr.end, e.name[len(SPAN):]))
        elif _device(e):
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "kernel_s": {},
                "device_ops": [], "idle_gaps": [], "n_device_ops": 0}
    dev.sort()
    host.sort()
    spans.sort()
    kernel_s: dict[str, float] = defaultdict(float)
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, name in dev:
        kernel_s[name] += (e - s) / 1e6
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    starts = [h[0] for h in host]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < SMALL_GAP_US:
            idle[f"gaps under {SMALL_GAP_US:g} us between operations"] += (b - a) / 1e6
            continue
        idle[_host_at(host, starts, spans, (a + b) / 2)] += (b - a) / 1e6
    # the host before the first and after the last device operation
    lead = window_s - busy / 1e6 - sum(idle.values())
    if lead > 0:
        idle["outside the first and last device operation"] += lead
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy / 1e6, "window_s": window_s, "kernel_s": dict(kernel_s),
            "device_ops": top(kernel_s), "idle_gaps": top(idle),
            "n_device_ops": len(dev)}


def _host_at(host, starts, spans, t: float) -> str:
    """The benchmark's span and the innermost host operation at time t."""
    span = next((name for s, e, name in spans if s <= t <= e),
                "no benchmark span")
    i = bisect.bisect_right(starts, t)
    inner, inner_start = None, -1.0
    for j in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = host[j]
        if e >= t and s > inner_start:
            inner, inner_start = name, s
            break
    return span if inner is None else f"{span}: {inner[:60]}"


def kernel_seconds(trace: dict, needles) -> float:
    """Device seconds of the operations whose names hold any of
    ``needles``."""
    return sum(t for name, t in trace["kernel_s"].items()
               if any(n in name for n in needles))
