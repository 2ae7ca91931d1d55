"""Zero-dependency request tracing with explicit, injectable time.

The span model is OpenTelemetry-shaped (name, start, end, attrs, parent)
but deliberately tiny: spans are plain records collected by a
:class:`Tracer`, and *time is always explicit*.  Every recording call
accepts a timestamp, so the same instrumentation serves both the
wall-clock live engines (times from ``time.perf_counter``) and the
virtual-time simulators (`FleetSimulator` / `DisaggSimulator`), whose
"now" is a scheduling variable, not a reading of any clock.  When a
timestamp is omitted the tracer falls back to its injected clock.

Three recording shapes cover every seam in the stack:

- ``span(name, t_start, t_end)`` — a completed interval (most sim spans
  are known only once the service line has reserved them).
- ``begin(name, t)`` / ``end(span, t)`` — an open interval for the live
  path (root request spans open at arrival, close at absorb).
- ``event(name, t)`` — an instant (router decisions, autoscaler actions,
  XLA compile markers).

Spans carry an optional ``resource`` — the serialized thing they occupy
(a service line, a transfer link, a decode slot).  Spans that share a
resource must not overlap; :func:`validate_trace` enforces this.  Spans
with ``resource=None`` are logical (request roots, queue waits) and are
exported as async nestable events instead of thread-track slices.

The default recorder everywhere is :data:`NULL_TRACER`, whose methods
are no-ops; instrumented hot paths guard expensive attribute
construction behind ``tracer.enabled``.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "WallClock",
    "VirtualClock",
    "to_chrome",
    "write_chrome",
    "validate_trace",
    "validate_chrome",
]


# ---------------------------------------------------------------------------
# clocks


class WallClock:
    """Monotonic wall clock, re-zeroed at construction so traces start ~0."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0


class VirtualClock:
    """A settable clock for virtual-time simulation.

    The simulator owns time: it calls :meth:`set` as its event loop
    advances, and instrumentation that omits explicit timestamps reads
    the last set value.
    """

    def __init__(self, t: float = 0.0) -> None:
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def set(self, t: float) -> None:
        self.t = float(t)

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# ---------------------------------------------------------------------------
# spans


@dataclass
class Span:
    """One named interval (or instant, when ``t_end == t_start``)."""

    name: str
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    resource: Optional[str] = None

    @property
    def duration(self) -> float:
        return (self.t_end - self.t_start) if self.t_end is not None else float("nan")

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "attrs": dict(self.attrs),
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "resource": self.resource,
        }


ParentLike = Union[Span, int, None]


def _parent_id(parent: ParentLike) -> Optional[int]:
    if parent is None:
        return None
    if isinstance(parent, Span):
        return parent.span_id
    return int(parent)


class Tracer:
    """Collects spans; time is explicit, with an injectable fallback clock."""

    enabled: bool = True

    def __init__(self, clock: Any = None) -> None:
        self.clock = clock if clock is not None else WallClock()
        self.spans: List[Span] = []
        self._next_id = 1

    # -- recording ----------------------------------------------------------

    def _now(self, t: Optional[float]) -> float:
        return float(t) if t is not None else float(self.clock.now())

    def begin(
        self,
        name: str,
        t: Optional[float] = None,
        *,
        parent: ParentLike = None,
        resource: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Open a span at ``t`` (or clock-now); close it with :meth:`end`."""
        s = Span(
            name=name,
            t_start=self._now(t),
            attrs=attrs,
            span_id=self._next_id,
            parent_id=_parent_id(parent),
            resource=resource,
        )
        self._next_id += 1
        self.spans.append(s)
        return s

    def end(self, span: Span, t: Optional[float] = None, **attrs: Any) -> Span:
        span.t_end = self._now(t)
        if attrs:
            span.attrs.update(attrs)
        return span

    def span(
        self,
        name: str,
        t_start: float,
        t_end: float,
        *,
        parent: ParentLike = None,
        resource: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Record an already-completed interval (the sim-side common case)."""
        s = Span(
            name=name,
            t_start=float(t_start),
            t_end=float(t_end),
            attrs=attrs,
            span_id=self._next_id,
            parent_id=_parent_id(parent),
            resource=resource,
        )
        self._next_id += 1
        self.spans.append(s)
        return s

    def event(
        self,
        name: str,
        t: Optional[float] = None,
        *,
        parent: ParentLike = None,
        resource: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Record an instant (a zero-duration span)."""
        now = self._now(t)
        return self.span(name, now, now, parent=parent, resource=resource, **attrs)

    # -- introspection ------------------------------------------------------

    def open_spans(self) -> List[Span]:
        return [s for s in self.spans if not s.closed]

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def snapshot(self) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.spans]

    def reset(self) -> None:
        self.spans = []
        self._next_id = 1

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        return to_chrome(self.spans)

    def write_chrome(self, path: str) -> None:
        write_chrome(self.spans, path)


class NullTracer(Tracer):
    """No-op recorder: the default everywhere; records nothing.

    Instrumented call sites may call any recording method unguarded —
    every method returns immediately.  Sites that would *construct*
    expensive attributes should still guard on ``tracer.enabled``.
    """

    enabled = False

    def __init__(self) -> None:  # no clock, no storage
        self.clock = None
        self.spans = []
        self._next_id = 1

    _NULL_SPAN = None  # set after class definition

    def begin(self, name, t=None, *, parent=None, resource=None, **attrs):  # type: ignore[override]
        return NullTracer._NULL_SPAN

    def end(self, span, t=None, **attrs):  # type: ignore[override]
        return span

    def span(self, name, t_start, t_end, *, parent=None, resource=None, **attrs):  # type: ignore[override]
        return NullTracer._NULL_SPAN

    def event(self, name, t=None, *, parent=None, resource=None, **attrs):  # type: ignore[override]
        return NullTracer._NULL_SPAN


NullTracer._NULL_SPAN = Span(name="null", t_start=0.0, t_end=0.0, span_id=0)

NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)

_US = 1e6  # trace-event timestamps are microseconds


def _ancestor_id(span: Span, by_id: Dict[int, Span]) -> int:
    """Walk to the top-most ancestor; async events nest by shared id."""
    cur = span
    seen = set()
    while cur.parent_id is not None and cur.parent_id in by_id and cur.span_id not in seen:
        seen.add(cur.span_id)
        cur = by_id[cur.parent_id]
    return cur.span_id


def to_chrome(spans: Iterable[Span]) -> Dict[str, Any]:
    """Render spans as a Chrome trace-event JSON object.

    Resource-bound spans become ``"X"`` complete events on one named
    thread track per resource (so Perfetto shows occupancy per service
    line / link / slot); resource-less spans become async ``"b"``/``"e"``
    pairs grouped under their root ancestor's id, so each request reads
    as one nested async track; instants become ``"i"`` events.
    """
    spans = list(spans)
    by_id = {s.span_id: s for s in spans}
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_for(resource: str) -> int:
        if resource not in tids:
            tids[resource] = len(tids) + 1
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tids[resource],
                    "args": {"name": resource},
                }
            )
        return tids[resource]

    for s in spans:
        if not s.closed:
            continue
        args = {"span_id": s.span_id, "parent_id": s.parent_id, **s.attrs}
        if s.resource is not None and s.t_end > s.t_start:
            events.append(
                {
                    "name": s.name,
                    "cat": "resource",
                    "ph": "X",
                    "ts": s.t_start * _US,
                    "dur": (s.t_end - s.t_start) * _US,
                    "pid": 1,
                    "tid": tid_for(s.resource),
                    "args": args,
                }
            )
        elif s.t_end > s.t_start:
            gid = str(_ancestor_id(s, by_id))
            common = {"cat": "request", "id": gid, "pid": 1, "tid": 0, "args": args}
            events.append({"name": s.name, "ph": "b", "ts": s.t_start * _US, **common})
            events.append({"name": s.name, "ph": "e", "ts": s.t_end * _US, **common})
        else:  # instant
            tid = tid_for(s.resource) if s.resource is not None else 0
            events.append(
                {
                    "name": s.name,
                    "cat": "event",
                    "ph": "i",
                    "s": "t",
                    "ts": s.t_start * _US,
                    "pid": 1,
                    "tid": tid,
                    "args": args,
                }
            )

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(spans: Iterable[Span], path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(spans), f)


# ---------------------------------------------------------------------------
# validation (also used by CI via repro.telemetry.validate)

_EPS = 1e-9


def validate_trace(spans: Sequence[Span]) -> List[str]:
    """Structural checks over raw spans; returns a list of problems.

    - every span must be closed with ``t_end >= t_start``;
    - every ``parent_id`` must reference a recorded span;
    - spans sharing a ``resource`` must not overlap (the resource is a
      serialized thing — a service line, a link, a decode slot).
    """
    problems: List[str] = []
    ids = {s.span_id for s in spans}
    by_resource: Dict[str, List[Span]] = {}
    for s in spans:
        if not s.closed:
            problems.append(f"open span: {s.name} (id={s.span_id})")
            continue
        if s.t_end < s.t_start - _EPS:
            problems.append(
                f"negative duration: {s.name} (id={s.span_id}) "
                f"{s.t_start:.6f}..{s.t_end:.6f}"
            )
        if s.parent_id is not None and s.parent_id not in ids:
            problems.append(
                f"orphan span: {s.name} (id={s.span_id}) "
                f"parent {s.parent_id} not recorded"
            )
        if s.resource is not None and s.t_end > s.t_start:
            by_resource.setdefault(s.resource, []).append(s)
    for resource, group in by_resource.items():
        group.sort(key=lambda s: (s.t_start, s.t_end))
        for a, b in zip(group, group[1:]):
            if b.t_start < a.t_end - _EPS:
                problems.append(
                    f"overlap on resource {resource!r}: "
                    f"{a.name}(id={a.span_id}) [{a.t_start:.6f},{a.t_end:.6f}] vs "
                    f"{b.name}(id={b.span_id}) [{b.t_start:.6f},{b.t_end:.6f}]"
                )
    return problems


def validate_chrome(doc: Dict[str, Any]) -> List[str]:
    """The same checks, over an exported Chrome trace-event document."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    ids = set()
    for e in events:
        sid = (e.get("args") or {}).get("span_id")
        if sid is not None:
            ids.add(sid)
    open_async: Dict[tuple, int] = {}
    by_tid: Dict[tuple, List[tuple]] = {}
    for e in events:
        ph = e.get("ph")
        args = e.get("args") or {}
        pid_ref = args.get("parent_id")
        if ph in ("X", "b", "i") and pid_ref is not None and pid_ref not in ids:
            problems.append(f"orphan event: {e.get('name')} parent {pid_ref} unknown")
        if ph == "X":
            dur = e.get("dur", 0.0)
            if dur < -_EPS:
                problems.append(f"negative duration: {e.get('name')} dur={dur}")
            key = (e.get("pid"), e.get("tid"))
            by_tid.setdefault(key, []).append((e.get("ts", 0.0), e.get("ts", 0.0) + dur, e.get("name")))
        elif ph == "b":
            key = (e.get("cat"), e.get("id"), e.get("name"))
            open_async[key] = open_async.get(key, 0) + 1
        elif ph == "e":
            key = (e.get("cat"), e.get("id"), e.get("name"))
            open_async[key] = open_async.get(key, 0) - 1
    for key, n in open_async.items():
        if n != 0:
            problems.append(f"unbalanced async span: {key} (open count {n})")
    for key, group in by_tid.items():
        group.sort()
        for a, b in zip(group, group[1:]):
            if b[0] < a[1] - _EPS * _US:
                problems.append(
                    f"overlap on track {key}: {a[2]} [{a[0]:.1f},{a[1]:.1f}]us vs "
                    f"{b[2]} [{b[0]:.1f},{b[1]:.1f}]us"
                )
    return problems
