"""Operating-state energy landscape + basin selection (paper Fig. 1/5).

The bio-physical framing made operational: the space of serving
operating states (execution path x batch bucket) is scored with the
same J structure as per-request admission.  The controller does NOT
search for the global minimum — following the protein-folding analogy
it settles into the FIRST basin whose cost clears the acceptability
threshold ("a protein reaches an acceptable local minimum without
pursuing the absolute global minimum if the path is too costly").

Used by the dynamic batcher to pick its batch bucket, and by the
fig5 benchmark to draw the landscape + tau(t) trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.energy import EnergyModel


@dataclass(frozen=True)
class OperatingState:
    path: str                 # "direct" | "batched"
    batch: int                # batch bucket (1 for direct)

    def __str__(self):
        return f"{self.path}/b{self.batch}"


@dataclass
class LatencyModel:
    """Per-step latency of a serving config: t(b) = t_fixed + b * t_tok.

    ``t_fixed`` absorbs dispatch/orchestration overhead (higher for the
    managed-batching path — the paper's Triton at batch=1 observation);
    ``t_tok`` the per-sequence marginal compute time.
    """
    t_fixed_s: float
    t_tok_s: float

    def step_time(self, batch: int) -> float:
        return self.t_fixed_s + batch * self.t_tok_s


@dataclass
class CostLandscape:
    direct: LatencyModel
    batched: LatencyModel
    energy: EnergyModel = field(default_factory=EnergyModel)
    arrival_rate: float = 50.0          # req/s, for queue-fill wait time
    slo_s: float = 0.25
    alpha: float = 1.0                  # latency weight
    beta: float = 1.0                   # energy weight
    gamma: float = 0.5                  # stability weight

    def _model(self, st: OperatingState) -> LatencyModel:
        return self.direct if st.path == "direct" else self.batched

    def latency(self, st: OperatingState) -> float:
        """Expected request latency: fill wait + step time."""
        wait = 0.0 if st.batch == 1 else (st.batch - 1) / (
            2.0 * max(self.arrival_rate, 1e-6))
        return wait + self._model(st).step_time(st.batch)

    def joules_per_request(self, st: OperatingState) -> float:
        step = self._model(st).step_time(st.batch)
        return self.energy.p_active * step / st.batch

    def cost(self, st: OperatingState) -> float:
        """J of an operating state (normalised, dimensionless)."""
        lat = self.latency(st) / self.slo_s
        b1 = OperatingState(st.path, 1)
        e = self.joules_per_request(st) / max(
            self.joules_per_request(b1), 1e-9)
        # stability: over-large batches risk queue oscillation when the
        # fill wait approaches the SLO ("costly transitions", Table I)
        wait_frac = (self.latency(st) - self._model(st).step_time(st.batch)
                     ) / self.slo_s
        stab = wait_frac ** 2
        den = self.alpha + self.beta + self.gamma
        return (self.alpha * lat + self.beta * e + self.gamma * stab) / den

    # ------------------------------------------------------------------
    def states(self, max_batch: int = 64) -> list[OperatingState]:
        out = [OperatingState("direct", 1)]
        b = 1
        while b <= max_batch:
            out.append(OperatingState("batched", b))
            b *= 2
        return out

    def evaluate(self, states: Sequence[OperatingState] | None = None):
        states = list(states or self.states())
        return states, [self.cost(s) for s in states]

    def basins(self, states=None) -> list[int]:
        """Indices of local minima along the enumerated state order."""
        states, costs = self.evaluate(states)
        idx = []
        for i in range(len(costs)):
            left = costs[i - 1] if i > 0 else math.inf
            right = costs[i + 1] if i + 1 < len(costs) else math.inf
            if costs[i] <= left and costs[i] <= right:
                idx.append(i)
        return idx

    def first_acceptable_basin(self, tau: float, states=None
                               ) -> OperatingState | None:
        """First local minimum with cost <= tau (folding semantics) —
        NOT the argmin.  None if no basin is acceptable yet (caller
        keeps the permissive startup config and waits for tau(t) or the
        load to move)."""
        states, costs = self.evaluate(states)
        for i in self.basins(states):
            if costs[i] <= tau:
                return states[i]
        return None

    def global_minimum(self, states=None) -> OperatingState:
        states, costs = self.evaluate(states)
        return states[costs.index(min(costs))]
