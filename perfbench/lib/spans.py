"""The card's idle time in a traced window put down to what the decode
session's host was doing: the session's own spans (``DecodeSession``'s
``tracer``, a ``repro_torch.telemetry.trace.Tracer`` on a ``WallClock``)
laid on the profile's timeline beside its device operations.

The clocks: a ``WallClock``'s zero is ``epoch_ns`` on ``time.time_ns()``'s
scale, and Kineto puts its host and device events on that scale less the
profile's ``trace_start_ns``, in microseconds (``FunctionEvent.time_range``).
``timeline`` makes that one shift; ``reduce`` then keeps the device
operations that start inside the benchmark's window span, rebuilds the
idle intervals between them as ``profile.reduce`` does, and splits each
interval of 50 us or more exactly across the innermost session span over
each part of it.  Idle between two ``decode.advance`` spans is the
caller's.  Device-side copies of user annotations (the benchmark's
``pb.`` spans among them) are no device work.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

from perfbench.lib import profile

CALLER = "caller"                       # between two decode.advance spans
OUTSIDE = "outside the session's spans"
ALIGN_US = 500.0


@dataclass(frozen=True)
class Stretch:
    """A session span on the profile's timeline, in microseconds."""
    name: str
    start: float
    end: float
    span_id: int
    parent_id: int | None


def timeline(spans, epoch_ns: int, trace_start_ns: int) -> list[Stretch]:
    """The closed ``spans``, timed on a clock whose zero is ``epoch_ns``,
    on the microseconds of a profile that started at ``trace_start_ns``."""
    shift = epoch_ns - trace_start_ns
    return [Stretch(s.name, (shift + s.t_start * 1e9) / 1e3,
                    (shift + s.t_end * 1e9) / 1e3, s.span_id, s.parent_id)
            for s in spans if s.t_end is not None]


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _device_work(e) -> bool:
    return (_on_device(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(profile.SPAN))


def _segments(stretches: list[Stretch]) -> list[tuple[float, float, str]]:
    """``[start, end, name]`` pieces, in order, that cover the first span's
    start to the last span's end: each the innermost span over it, or
    ``CALLER`` between two top-level spans.  The spans nest (one host
    thread opens and closes them in turn)."""
    out, stack, cursor = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s in sorted(stretches, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            emit(cursor, top.end, top.name)
            cursor = top.end
        if cursor is not None:
            emit(cursor, s.start, stack[-1].name if stack else CALLER)
        stack.append(s)
        cursor = s.start
    while stack:
        top = stack.pop()
        emit(cursor, top.end, top.name)
        cursor = top.end
    return out


def _alignment(stretches: list[Stretch], dev: list) -> dict:
    """For each window, its last device operation's end against the end
    of its ``decode.window.sync`` span: the operations are those that
    start between the window's issue and the end of its advance."""
    by_id = {s.span_id: s for s in stretches}
    issue = {s.parent_id: s for s in stretches if s.name == "decode.window.issue"}
    starts = [d[0] for d in dev]
    offsets, passed = [], 0
    for sync in (s for s in stretches if s.name == "decode.window.sync"):
        adv, iss = by_id.get(sync.parent_id), issue.get(sync.parent_id)
        if adv is None or iss is None:
            continue
        i, j = (bisect.bisect_left(starts, iss.start),
                bisect.bisect_right(starts, adv.end))
        if i == j:
            continue
        last = max(d[1] for d in dev[i:j])
        offsets.append(last - sync.end)
        passed += sync.start <= last <= sync.end + ALIGN_US
    return {"windows": len(offsets), "passed": passed,
            "offset_us": [min(offsets), max(offsets)] if offsets else None}


def reduce(events, stretches: list[Stretch]) -> dict:
    """``events``: the profiler's ``events()``; ``stretches``: the session's
    spans from ``timeline``.  -> ``idle_s``, ``host_s`` and ``count`` by
    span name (``CALLER`` too; idle also ``OUTSIDE``), ``small_gaps_s``
    (gaps under 50 us between operations, not split), ``busy_s`` and
    ``window_s`` of the window span, and ``alignment``."""
    events = list(events)
    win = next(((e.time_range.start, e.time_range.end) for e in events
                if e.name == profile.SPAN + profile.WINDOW
                and not _on_device(e)), None)
    inside = (lambda t: True) if win is None else (lambda t: win[0] <= t <= win[1])
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if _device_work(e) and inside(e.time_range.start))
    stretches = [s for s in stretches if inside(s.start)]
    host: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for s in stretches:
        host[s.name] += (s.end - s.start) / 1e6
        count[s.name] += 1
    tops = sorted((s.start, s.end) for s in stretches if s.parent_id is None)
    for (_, e0), (s1, _) in zip(tops, tops[1:]):
        host[CALLER] += (s1 - e0) / 1e6
        count[CALLER] += 1
    lo, hi = win if win is not None else (dev[0][0] if dev else 0.0,
                                          dev[-1][1] if dev else 0.0)
    idle_iv, small, busy = [], 0.0, 0.0
    cur = None
    for s, e in dev:
        if cur is None:
            idle_iv.append((lo, s))
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            if s - cur[1] < profile.SMALL_GAP_US:
                small += s - cur[1]
            else:
                idle_iv.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is None:
        idle_iv.append((lo, hi))
    else:
        busy += cur[1] - cur[0]
        idle_iv.append((cur[1], hi))
    segs = _segments(stretches)
    seg_starts = [a for a, _, _ in segs]
    idle: dict[str, float] = defaultdict(float)
    for a, b in idle_iv:
        if b <= a:
            continue
        covered = 0.0
        k = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        for s, e, name in segs[k:]:
            if s >= b:
                break
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[name] += part / 1e6
                covered += part
        if b - a - covered > 0:
            idle[OUTSIDE] += (b - a - covered) / 1e6
    return {"idle_s": dict(idle), "host_s": dict(host), "count": dict(count),
            "small_gaps_s": small / 1e6, "busy_s": busy / 1e6,
            "window_s": (hi - lo) / 1e6, "alignment": _alignment(stretches, dev)}
