"""Closed-loop discrete-event simulation — the paper's testbed, virtual —
ported from ``repro.serving.simulator``.

The lifecycle (arrival stream -> admission controller -> dual-path
scheduler -> energy accounting -> EWMA/congestion feedback) lives in
``repro_torch.serving.api.Server``; this module keeps the
simulator-specific pieces: the ``Oracle`` (precomputed per-request
model behaviour, replayed by ``adapters.OracleEngine``, so request
sweeps run in milliseconds and every run is exactly reproducible), the
``SimMetrics`` report, and ``ClosedLoopSimulator``, the reference's
shim that builds a ``Server`` over an ``OracleEngine``.  Host code
only: no tensor, no card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import numpy as np

from repro_torch.core.controller import AdmissionController
from repro_torch.core.energy import EnergyModel
from repro_torch.core.landscape import LatencyModel
from repro_torch.serving.api import (PATH_DYNAMIC_BATCH, Server,
                                     ServerConfig, canonical_path)
from repro_torch.serving.batcher import DirectPath, DynamicBatcher
from repro_torch.serving.workload import Request


@dataclass
class Oracle:
    """Per-request model behaviour, precomputed (index = request rid)."""
    full_pred: np.ndarray            # [N]
    proxy_pred: np.ndarray           # [N]
    entropy: np.ndarray              # [N] proxy softmax entropy (L(x))
    labels: np.ndarray | None = None
    proxy_latency: LatencyModel | None = None   # triage cost


@dataclass
class ServedRecord:
    rid: int
    arrival: float
    finish: float
    admitted: bool
    path: str
    pred: int
    correct: bool | None
    batch_size: int = 1

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


@dataclass
class SimMetrics:
    records: list[ServedRecord]
    busy_s: float
    span_s: float
    energy_model: EnergyModel
    n_chips: int = 1

    def _lat(self):
        return np.array([r.latency for r in self.records])

    @property
    def n(self):
        return len(self.records)

    @property
    def admission_rate(self):
        return np.mean([r.admitted for r in self.records])

    @property
    def mean_latency_s(self):
        return float(self._lat().mean())

    @property
    def std_latency_s(self):
        return float(self._lat().std())

    @property
    def p95_latency_s(self):
        return float(np.percentile(self._lat(), 95))

    @property
    def throughput_qps(self):
        return self.n / max(self.span_s, 1e-9)

    @property
    def total_time_s(self):
        return self.span_s

    @property
    def energy_j(self):
        busy = self.energy_model.p_active * self.busy_s * self.n_chips
        idle = self.energy_model.p_idle * max(
            self.span_s - self.busy_s, 0.0) * self.n_chips
        return busy + idle

    @property
    def energy_kwh(self):
        return self.energy_j / 3.6e6

    @property
    def co2_kg(self):
        return EnergyModel.co2_kg(self.energy_j)

    @property
    def accuracy(self):
        cs = [r.correct for r in self.records if r.correct is not None]
        return float(np.mean(cs)) if cs else float("nan")

    def summary(self) -> dict:
        return {
            "n": self.n,
            "admission_rate": round(float(self.admission_rate), 4),
            "mean_latency_ms": round(self.mean_latency_s * 1e3, 3),
            "std_latency_ms": round(self.std_latency_s * 1e3, 3),
            "p95_latency_ms": round(self.p95_latency_s * 1e3, 3),
            "throughput_qps": round(self.throughput_qps, 2),
            "total_time_s": round(self.span_s, 4),
            "busy_s": round(self.busy_s, 4),
            "energy_kwh": round(self.energy_kwh, 9),
            "co2_kg": round(self.co2_kg, 9),
            "accuracy": round(self.accuracy, 4),
        }


@dataclass
class ClosedLoopSimulator:
    """The reference's shim over the unified API: builds a
    :class:`repro_torch.serving.api.Server` over an
    :class:`repro_torch.serving.adapters.OracleEngine` with the
    controller plugged in as admission middleware, then converts the
    unified responses back into ``SimMetrics``.
    """
    oracle: Oracle
    controller: AdmissionController
    direct: DirectPath
    batched: DynamicBatcher
    energy_model: EnergyModel = field(default_factory=EnergyModel)
    path: Literal["direct", "batched", "auto"] = "auto"
    auto_queue_threshold: int = 4     # route to batcher when loaded
    n_chips: int = 1

    def run(self, requests: list[Request]) -> SimMetrics:
        # adapters imports this module (for the Oracle)
        from repro_torch.serving.adapters import OracleEngine

        server = Server(
            engine=OracleEngine(self.oracle, self.direct, self.batched),
            config=ServerConfig(
                path=canonical_path(self.path),
                auto_queue_threshold=self.auto_queue_threshold,
                n_chips=self.n_chips, energy_model=self.energy_model),
            middleware=[self.controller.as_middleware()])
        responses = server.serve(requests)

        legacy = {PATH_DYNAMIC_BATCH: "batched"}
        recs = []
        for r in responses:
            lbl = r.label
            if lbl is None and self.oracle.labels is not None:
                lbl = int(self.oracle.labels[r.rid])
            pred = int(r.output)
            recs.append(ServedRecord(
                rid=r.rid, arrival=r.arrival_s, finish=r.t_finish,
                admitted=r.admitted, path=legacy.get(r.path, r.path),
                pred=pred, correct=None if lbl is None else pred == lbl,
                batch_size=r.batch_size))
        return SimMetrics(records=recs, busy_s=server.busy_s,
                          span_s=server.span_s,
                          energy_model=self.energy_model,
                          n_chips=self.n_chips)
