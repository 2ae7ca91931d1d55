"""Framework-free telemetry copied from ``repro.telemetry``: request
log, carbon accounting, run tracker, tracer, metrics registry, the
energy-drift audit (with the card's own energy counter through NVML),
and the build and capture watcher that stands in for the reference's
XLA compile watcher."""
from repro_torch.telemetry.carbon import (CarbonTracker,
                                          GRID_INTENSITY_KG_PER_KWH)
from repro_torch.telemetry.compile_watch import CompileWatcher
from repro_torch.telemetry.drift import (EnergyDriftAudit, MeasuredSource,
                                         NvmlSource, ProcessTimeSource,
                                         TpuSource, make_measured_source)
from repro_torch.telemetry.metrics import (NULL_METRICS, MetricsRegistry,
                                           NullMetrics)
from repro_torch.telemetry.request_log import RequestLog
from repro_torch.telemetry.trace import (NULL_TRACER, NullTracer, Span,
                                         Tracer, VirtualClock, WallClock,
                                         to_chrome, validate_chrome,
                                         validate_trace)
from repro_torch.telemetry.tracker import Run, Tracker

__all__ = ["CarbonTracker", "GRID_INTENSITY_KG_PER_KWH", "RequestLog",
           "CompileWatcher",
           "Run", "Tracker",
           "Span", "Tracer", "NullTracer", "NULL_TRACER",
           "WallClock", "VirtualClock",
           "to_chrome", "validate_trace", "validate_chrome",
           "MetricsRegistry", "NullMetrics", "NULL_METRICS",
           "EnergyDriftAudit", "MeasuredSource", "ProcessTimeSource",
           "NvmlSource", "TpuSource", "make_measured_source",
           "export_observability"]


def export_observability(run, tracer=None, metrics=None, audit=None):
    """Land observability artifacts beside a Tracker run's CSVs.

    Writes ``trace.json`` (Chrome trace-event, Perfetto-loadable),
    ``metrics.json`` + ``metrics.prom`` (snapshot + Prometheus text),
    and ``energy_drift.json``; skips anything not provided or disabled.
    Returns the artifact paths written.
    """
    import os

    paths = {}
    if tracer is not None and tracer.enabled and tracer.spans:
        paths["trace"] = run.log_artifact("trace.json", tracer.to_chrome())
    if metrics is not None and metrics.enabled:
        paths["metrics"] = run.log_artifact("metrics.json", metrics.snapshot())
        prom = os.path.join(run.run_dir, "metrics.prom")
        metrics.write_prometheus(prom)
        paths["prometheus"] = prom
    if audit is not None:
        paths["drift"] = run.log_artifact("energy_drift.json", audit.report())
    return paths
