"""Build-time observability: the port's counterpart of the reference's
XLA compile watcher (``repro.telemetry.compile_watch``).

The reference's cold start is paid in XLA compiles.  The port's is paid
in two other ways: ``nvcc`` builds of the CUDA kernel libraries
(``kernels.build``; a library already in the build directory is opened
as built, the counterpart of a persistent-cache hit), and CUDA-graph
captures of the decode window (``kernels.graphs.CountedGraph``).  Both
modules keep a process-wide log; a watcher reads the entries made while
it is installed and exports

  - ``cuda.build`` spans, one per ``nvcc``, each library on its own
    ``cuda.build/<library>`` resource track (the builds run in
    parallel, so one track would overlap), and ``cuda.capture`` spans
    on the ``cuda.capture`` track (captures run one at a time);
  - a ``compile_seconds`` gauge: the ``nvcc`` seconds of the window,
    ALWAYS set, 0.0 on a warm start, so a check can require it;
  - ``compile_events`` (builds and captures, by ``kind``) and
    ``compile_cache_hits`` (libraries opened as built) counters, and a
    ``capture_seconds`` gauge.

The spans are on the wall clock, as the reference's: builds and
captures are real host work even under a virtual-clock simulation.
"""
from __future__ import annotations

from typing import Any

from repro_torch.kernels import build, graphs

__all__ = ["CompileWatcher"]


class CompileWatcher:
    """The builds, cache hits and captures of one observed run:
    ``install()`` marks where the run starts in the process-wide logs,
    ``export`` writes spans and metrics for what came after."""

    def __init__(self) -> None:
        self._marks: tuple[int, int, int] | None = None

    def install(self) -> "CompileWatcher":
        self._marks = (len(build.build_log), len(build.hit_log),
                       len(graphs.capture_log))
        return self

    def _since(self):
        if self._marks is None:          # not installed: sees nothing
            return [], [], []
        b, h, c = self._marks
        return (build.build_log[b:], build.hit_log[h:],
                graphs.capture_log[c:])

    # -- accessors ---------------------------------------------------------

    @property
    def compile_seconds(self) -> float:
        return sum((secs for _, secs, _ in self._since()[0]), 0.0)

    @property
    def compile_count(self) -> int:
        return len(self._since()[0])

    @property
    def cache_hits(self) -> int:
        return len(self._since()[1])

    @property
    def capture_count(self) -> int:
        return len(self._since()[2])

    @property
    def capture_seconds(self) -> float:
        return sum((secs for _, secs in self._since()[2]), 0.0)

    # -- export ------------------------------------------------------------

    def export(self, tracer: Any = None, metrics: Any = None) -> dict:
        """Emit spans and metrics and release the window.  The gauges
        are set even when nothing was built (0.0)."""
        builds, hits, captures = self._since()
        if tracer is not None and getattr(tracer, "enabled", True):
            for start, secs, name in builds:
                tracer.span("cuda.build", start, start + secs,
                            resource=f"cuda.build/{name}", library=name,
                            seconds=secs)
            last_end = 0.0
            for start, secs in sorted(captures):
                start = max(start, last_end)
                tracer.span("cuda.capture", start, start + secs,
                            resource="cuda.capture", seconds=secs)
                last_end = start + secs
        report = {"compile_seconds": self.compile_seconds,
                  "compile_count": len(builds),
                  "cache_hits": len(hits),
                  "capture_count": len(captures),
                  "capture_seconds": self.capture_seconds}
        if metrics is not None and getattr(metrics, "enabled", True):
            metrics.gauge("compile_seconds",
                          "nvcc wall seconds this run (0 = every kernel "
                          "library opened as built)"
                          ).set(report["compile_seconds"])
            metrics.gauge("capture_seconds",
                          "CUDA-graph capture seconds this run"
                          ).set(report["capture_seconds"])
            c = metrics.counter("compile_events",
                                "nvcc builds and CUDA-graph captures this "
                                "run")
            if builds:
                c.inc(len(builds), kind="nvcc")
            if captures:
                c.inc(len(captures), kind="capture")
            h = metrics.counter("compile_cache_hits",
                                "kernel libraries opened as built")
            if hits:
                h.inc(len(hits))
        self._marks = None
        return report
