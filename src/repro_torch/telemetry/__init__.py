"""Framework-free telemetry copied from ``repro.telemetry``: request
log, carbon accounting, run tracker, tracer and metrics registry."""
