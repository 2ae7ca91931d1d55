"""Per-request serving telemetry — the unified API's audit trail.

Every execution path (direct, dynamic-batch, gated-in-graph,
continuous-decode) produces ``InferResponse`` objects with the same
timing/energy/decision fields; ``RequestLog`` aggregates them into the
summary dict the paper's tables report (latency stats, throughput,
energy/CO2, admission rate, accuracy) and exports flat per-request rows
for the Tracker ("CSV for audit").

The summary formulas intentionally match ``SimMetrics`` so the legacy
simulator entry point and ``repro.serving.api.Server`` report identical
numbers for identical runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.energy import EnergyModel


@dataclass
class RequestLog:
    """Aggregates per-request responses + server-level counters."""
    energy_model: EnergyModel = field(default_factory=EnergyModel)
    n_chips: int = 1
    responses: list = field(default_factory=list)
    busy_s: float = 0.0
    span_s: float = 1e-9

    def add(self, resp) -> None:
        self.responses.append(resp)

    def discard(self, resp) -> None:
        """Withdraw a previously-added response (a crash clawed back
        an optimistically-minted future completion).  Missing entries
        are ignored — discarding twice is not an error."""
        try:
            self.responses.remove(resp)
        except ValueError:
            pass

    # -- derived metrics (SimMetrics-compatible) ------------------------
    @property
    def n(self) -> int:
        return len(self.responses)

    def _lat(self) -> np.ndarray:
        return np.array([r.t_finish - r.arrival_s for r in self.responses],
                        dtype=float)

    @property
    def admission_rate(self) -> float:
        if not self.responses:
            return float("nan")
        return float(np.mean([r.admitted for r in self.responses]))

    @property
    def energy_j(self) -> float:
        busy = self.energy_model.p_active * self.busy_s * self.n_chips
        idle = self.energy_model.p_idle * max(
            self.span_s - self.busy_s, 0.0) * self.n_chips
        return busy + idle

    @property
    def accuracy(self) -> float:
        cs = [int(r.output) == int(r.label) for r in self.responses
              if getattr(r, "label", None) is not None
              and np.isscalar(r.output)]
        return float(np.mean(cs)) if cs else float("nan")

    def summary(self) -> dict:
        lat = self._lat()
        # an empty log must read as "served nothing" (NaN, matching
        # admission_rate's convention), never as 0 ms latency
        if lat.size:
            mean_ms = round(float(lat.mean()) * 1e3, 3)
            std_ms = round(float(lat.std()) * 1e3, 3)
            p95_ms = round(float(np.percentile(lat, 95)) * 1e3, 3)
        else:
            mean_ms = std_ms = p95_ms = float("nan")
        return {
            "n": self.n,
            "admission_rate": round(self.admission_rate, 4),
            "mean_latency_ms": mean_ms,
            "std_latency_ms": std_ms,
            "p95_latency_ms": p95_ms,
            "throughput_qps": round(self.n / max(self.span_s, 1e-9), 2),
            "total_time_s": round(self.span_s, 4),
            "busy_s": round(self.busy_s, 4),
            "energy_kwh": round(EnergyModel.kwh(self.energy_j), 9),
            "co2_kg": round(EnergyModel.co2_kg(self.energy_j), 9),
            "accuracy": round(self.accuracy, 4),
        }

    # -- audit export ---------------------------------------------------
    def rows(self) -> list[dict]:
        """Flat per-request rows (params + decision) for CSV/JSON."""
        out = []
        for r in self.responses:
            row = {
                "rid": r.rid,
                "path": r.path,
                "admitted": bool(r.admitted),
                "arrival_s": round(float(r.arrival_s), 6),
                "latency_s": round(float(r.t_finish - r.arrival_s), 6),
                "batch_size": r.batch_size,
                "energy_j": round(float(r.energy_j), 6),
            }
            d = getattr(r, "decision", None)
            if d is not None:
                row.update(J=round(d.J, 5), tau=round(d.tau, 5),
                           L=round(d.L, 5), E=round(d.E, 5),
                           C=round(d.C, 5))
            out.append(row)
        return out

    def log_to(self, run, *, name: str = "requests.json") -> None:
        """Write the audit rows + summary into a Tracker run."""
        run.log_artifact(name, self.rows())
        run.log_artifact("serving_summary.json", self.summary())
