"""A small labeled-metrics registry: counters, gauges, histograms.

Zero dependencies; two export shapes — a JSON-able snapshot (landed
beside run CSVs by the Tracker exporter) and Prometheus text exposition
(so a scrape endpoint or a file target can pick the same numbers up).

Instruments are cheap handles onto the registry; series are keyed by
sorted ``(label, value)`` tuples so ``inc(path="direct")`` and
``inc(**{"path": "direct"})`` aggregate together.  The default registry
everywhere is :data:`NULL_METRICS`, whose instruments drop writes —
instrumentation can call unguarded on the hot path.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "MetricsRegistry",
    "NullMetrics",
    "NULL_METRICS",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_BUCKETS",
]

LabelKey = Tuple[Tuple[str, str], ...]

# latency-flavoured default buckets (seconds), log-ish spaced
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


class Counter:
    """Monotonically increasing, per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        k = _key(labels)
        self.series[k] = self.series.get(k, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        return self.series.get(_key(labels), 0.0)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [{"labels": dict(k), "value": v} for k, v in sorted(self.series.items())]

    def prometheus(self) -> List[str]:
        lines = [f"# TYPE {self.name} counter"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for k, v in sorted(self.series.items()):
            lines.append(f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}")
        return lines


class Gauge:
    """Last-write-wins, per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        self.series[_key(labels)] = float(value)

    def add(self, value: float, **labels: Any) -> None:
        k = _key(labels)
        self.series[k] = self.series.get(k, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        return self.series.get(_key(labels), float("nan"))

    def snapshot(self) -> List[Dict[str, Any]]:
        return [{"labels": dict(k), "value": v} for k, v in sorted(self.series.items())]

    def prometheus(self) -> List[str]:
        lines = [f"# TYPE {self.name} gauge"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for k, v in sorted(self.series.items()):
            lines.append(f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}")
        return lines


class _HistSeries:
    __slots__ = ("counts", "total", "sum")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets  # cumulative-at-export; raw per-bucket here
        self.total = 0
        self.sum = 0.0


class Histogram:
    """Fixed upper-bound buckets (+Inf implicit), per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self.series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: Any) -> None:
        k = _key(labels)
        s = self.series.get(k)
        if s is None:
            s = self.series[k] = _HistSeries(len(self.buckets))
        i = bisect_left(self.buckets, float(value))
        if i < len(self.buckets):
            s.counts[i] += 1
        s.total += 1
        s.sum += float(value)

    def count(self, **labels: Any) -> int:
        s = self.series.get(_key(labels))
        return s.total if s else 0

    def snapshot(self) -> List[Dict[str, Any]]:
        out = []
        for k, s in sorted(self.series.items()):
            cum, acc = {}, 0
            for ub, c in zip(self.buckets, s.counts):
                acc += c
                cum[_fmt_value(ub)] = acc
            cum["+Inf"] = s.total
            out.append({"labels": dict(k), "buckets": cum, "count": s.total, "sum": s.sum})
        return out

    def prometheus(self) -> List[str]:
        lines = [f"# TYPE {self.name} histogram"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for k, s in sorted(self.series.items()):
            acc = 0
            for ub, c in zip(self.buckets, s.counts):
                acc += c
                lines.append(f"{self.name}_bucket{_fmt_labels(k, (('le', _fmt_value(ub)),))} {acc}")
            lines.append(f"{self.name}_bucket{_fmt_labels(k, (('le', '+Inf'),))} {s.total}")
            lines.append(f"{self.name}_sum{_fmt_labels(k)} {_fmt_value(s.sum)}")
            lines.append(f"{self.name}_count{_fmt_labels(k)} {s.total}")
        return lines


class MetricsRegistry:
    """Named instruments; get-or-create semantics, kind-checked."""

    enabled: bool = True

    def __init__(self) -> None:
        self._instruments: Dict[str, Any] = {}

    def _get(self, cls: type, name: str, help: str, **kw: Any) -> Any:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.__name__.lower()}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Tuple[float, ...]] = None
    ) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, help)
        return self._get(Histogram, name, help, buckets=buckets)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(self._instruments.items()):
            out[inst.kind + "s"][name] = inst.snapshot()
        return out

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for _, inst in sorted(self._instruments.items()):
            lines.extend(inst.prometheus())
        return "\n".join(lines) + ("\n" if lines else "")

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def reset(self) -> None:
        self._instruments = {}


class _NullInstrument:
    """Accepts any write, stores nothing."""

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        pass

    def set(self, value: float, **labels: Any) -> None:
        pass

    def add(self, value: float, **labels: Any) -> None:
        pass

    def observe(self, value: float, **labels: Any) -> None:
        pass

    def value(self, **labels: Any) -> float:
        return 0.0

    def count(self, **labels: Any) -> int:
        return 0


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics(MetricsRegistry):
    """The default registry: every instrument is a shared no-op."""

    enabled = False

    def __init__(self) -> None:
        self._instruments = {}

    def counter(self, name: str, help: str = "") -> Any:  # type: ignore[override]
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "") -> Any:  # type: ignore[override]
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "", buckets: Any = None) -> Any:  # type: ignore[override]
        return _NULL_INSTRUMENT


NULL_METRICS = NullMetrics()
