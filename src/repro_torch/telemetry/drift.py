"""Modelled-vs-measured energy drift audit.

The stack's energy numbers are *modelled* (roofline `EnergyModel`); the
paper's auditability claim needs them checked against a *measured*
source.  `EnergyDriftAudit` accumulates modelled joules as runs report
them and brackets the run with readings from a pluggable measured
source, surfacing the drift ratio (modelled / measured) as a
first-class metric.

Measured sources implement one method — ``read_j() -> float`` returning
cumulative joules since an arbitrary epoch.  The default is a
process-time proxy (CPU-seconds × active power): crude, but monotone,
dependency-free, and available everywhere CI runs.  NVML and TPU
readers slot in behind the same protocol when their libraries exist;
they are import-gated and raise ``RuntimeError`` when unavailable
rather than adding dependencies.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = [
    "MeasuredSource",
    "ProcessTimeSource",
    "NvmlSource",
    "TpuSource",
    "EnergyDriftAudit",
    "make_measured_source",
]


class MeasuredSource:
    """Protocol: cumulative measured joules since an arbitrary epoch."""

    name = "abstract"

    def read_j(self) -> float:
        raise NotImplementedError


class ProcessTimeSource(MeasuredSource):
    """Process CPU-time × active power — the always-available proxy.

    On CPU-only CI the device work *is* process time, so this tracks the
    model's active term; on real accelerators it undercounts device
    joules and the drift ratio says so — which is the point.
    """

    name = "process-time"

    def __init__(self, p_active_w: float = 200.0) -> None:
        self.p_active_w = float(p_active_w)

    def read_j(self) -> float:
        return time.process_time() * self.p_active_w


class NvmlSource(MeasuredSource):
    """The card's total-energy counter through NVML (mJ since the
    NVIDIA kernel module loaded; Volta and later), read with ``ctypes``
    from NVIDIA's ``libnvidia-ml.so.1``.

    The counter includes the card's idle draw and advances in steps of
    some tens of milliseconds, so a short window reads coarsely.  The
    constructor raises ``RuntimeError`` when the library, one of its
    symbols or the device is missing, or a call fails."""

    name = "nvml"
    LIBRARY = "libnvidia-ml.so.1"

    def __init__(self, index: int = 0, library: str | None = None) -> None:
        lib_name = library or self.LIBRARY
        try:
            lib = ctypes.CDLL(lib_name)
            init = lib.nvmlInit_v2
            by_index = lib.nvmlDeviceGetHandleByIndex_v2
            energy = lib.nvmlDeviceGetTotalEnergyConsumption
        except (OSError, AttributeError) as e:
            raise RuntimeError(
                f"NVML energy source needs {lib_name} with "
                f"nvmlInit_v2, nvmlDeviceGetHandleByIndex_v2 and "
                f"nvmlDeviceGetTotalEnergyConsumption: {e}") from e
        for fn in (init, by_index, energy):
            fn.restype = ctypes.c_int
        init.argtypes = []
        by_index.argtypes = [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        energy.argtypes = [ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_ulonglong)]
        self._lib, self._energy = lib, energy
        self._check(init(), "nvmlInit_v2")
        handle = ctypes.c_void_p()
        self._check(by_index(int(index), ctypes.byref(handle)),
                    f"nvmlDeviceGetHandleByIndex_v2({index})")
        self._h = handle
        self.read_j()                # a card without the counter fails here

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:                  # NVML_SUCCESS
            err = getattr(self._lib, "nvmlErrorString", None)
            msg = ""
            if err is not None:
                err.restype = ctypes.c_char_p
                err.argtypes = [ctypes.c_int]
                msg = ": " + (err(rc) or b"").decode(errors="replace")
            raise RuntimeError(f"NVML {what} returned {rc}{msg}")

    def read_j(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._energy(self._h, ctypes.byref(mj)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3


class TpuSource(MeasuredSource):
    """TPU power telemetry is not exposed via a local library; placeholder.

    Cloud TPU exposes power through the monitoring API, not an on-host
    counter, so a real reader would poll that endpoint.  Kept as a named
    stub so configuration that asks for it fails loudly, not silently.
    """

    name = "tpu"

    def __init__(self) -> None:
        raise RuntimeError("TPU measured-energy source is not available on-host")


def make_measured_source(kind: str = "process", **kw: Any) -> MeasuredSource:
    if kind in ("process", "process-time", "proxy"):
        return ProcessTimeSource(**kw)
    if kind == "nvml":
        return NvmlSource(**kw)
    if kind == "tpu":
        return TpuSource(**kw)
    raise ValueError(f"unknown measured-energy source {kind!r}")


@dataclass
class EnergyDriftAudit:
    """Accumulates modelled J, brackets measured J, reports the ratio."""

    source: MeasuredSource = field(default_factory=ProcessTimeSource)
    modelled_j: float = 0.0
    n_requests: int = 0
    _j0: Optional[float] = None
    _measured_j: float = 0.0
    _t0: Optional[float] = None
    _window_s: float = 0.0           # wall seconds between start and stop

    def start(self) -> "EnergyDriftAudit":
        self._j0 = self.source.read_j()
        self._t0 = time.perf_counter()
        return self

    def record(self, modelled_j: float, n_requests: int = 1) -> None:
        self.modelled_j += float(modelled_j)
        self.n_requests += int(n_requests)

    def stop(self) -> Dict[str, Any]:
        if self._j0 is None:
            raise RuntimeError("EnergyDriftAudit.stop() before start()")
        self._measured_j = max(self.source.read_j() - self._j0, 0.0)
        self._window_s = time.perf_counter() - self._t0
        self._j0 = None
        return self.report()

    @property
    def measured_j(self) -> float:
        return self._measured_j

    @property
    def drift_ratio(self) -> float:
        if self._measured_j <= 0.0:
            return float("nan")
        return self.modelled_j / self._measured_j

    def report(self) -> Dict[str, Any]:
        n = max(self.n_requests, 1)
        return {
            "source": self.source.name,
            "modelled_j": self.modelled_j,
            "measured_j": self._measured_j,
            "drift_ratio": self.drift_ratio,
            "n_requests": self.n_requests,
            "modelled_j_per_request": self.modelled_j / n,
            "measured_j_per_request": self._measured_j / n,
            "window_s": self._window_s,
        }

    def export(self, metrics: Any) -> None:
        """Land the audit as gauges in a metrics registry."""
        src = self.source.name
        metrics.gauge(
            "energy_modelled_j", "modelled joules accumulated over the run"
        ).set(self.modelled_j, source=src)
        metrics.gauge(
            "energy_measured_j", "measured joules over the same window"
        ).set(self._measured_j, source=src)
        metrics.gauge(
            "energy_drift_ratio", "modelled / measured joules"
        ).set(self.drift_ratio, source=src)
