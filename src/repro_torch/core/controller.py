"""The closed-loop admission controller — the paper's contribution.

Appendix-A algorithm, faithfully:

    1. request x at time t
    2. L(x) from the proxy head's softmax entropy (the CUDA entropy kernel)
    3. E(x) from the EnergyMeter EWMA (CodeCarbon+NVML analogue)
    4. C(x) from queue depth / recent P95 / batch fill
    5. J(x) = alpha L + beta E + gamma C
    6. admit or skip against tau(t);  skipped requests are answered by
       the proxy prediction ("respond from cache")
    7. update tau(t);  log to the tracker

**Admission-rule note (DESIGN.md §7).** The paper's Eq. (2) says admit
iff J >= tau, but its Fig. 1, Table I ("admits points in the local
stable basin, skips high-cost paths"), the E/C rationales and the
Table-III ablation ("rejects requests with high entropic uncertainty or
arriving during congestion spikes") all require the opposite sign.  We
implement ``rule='le'`` (admit iff J <= tau — the coherent reading,
default, used for the ablation reproduction) and ``rule='ge'`` (the
literal Eq. (2)) behind one flag.

Two surfaces:
  - ``AdmissionController``: host-side, per-request (the faithful
    Python middleware, drives the dual-path scheduler);
  - ``gate_batch``: vectorised gate on tensors, so a whole
    triage+early-exit step stays on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import torch

from repro_torch.core.cost import CostModel
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.threshold import AdaptiveThreshold, DecayingThreshold


@dataclass
class CongestionState:
    """C(x) source: queue depth + recent P95 latency + batch fill."""
    queue_depth: int = 0
    p95_latency_s: float = 0.0
    batch_fill: float = 0.0          # 0..1 of max_batch_size
    max_queue: int = 64
    slo_latency_s: float = 0.5

    def value(self) -> float:
        q = min(self.queue_depth / max(self.max_queue, 1), 1.0)
        lat = min(self.p95_latency_s / max(self.slo_latency_s, 1e-9), 2.0)
        return (q + lat / 2.0 + self.batch_fill) / 3.0


@dataclass
class Decision:
    admit: bool
    J: float
    tau: float
    L: float
    E: float
    C: float
    t: float


@dataclass
class AdmissionController:
    cost: CostModel = field(default_factory=CostModel)
    threshold: DecayingThreshold | AdaptiveThreshold = field(
        default_factory=DecayingThreshold)
    meter: EnergyMeter = field(default_factory=EnergyMeter)
    congestion: CongestionState = field(default_factory=CongestionState)
    rule: Literal["le", "ge"] = "le"
    enabled: bool = True             # False = open-loop baseline
    # brownout hook (the faults layer): < 1 tightens the admission basin
    # under sustained failure pressure; 1.0 = no effect
    tau_scale: float = 1.0
    # speculative-decode coupling: the engine mirrors its live draft
    # depth (normalised to the compiled ceiling) here; gate_delta > 0
    # folds it into the gate objective as a fourth J(x) term (deep
    # drafts = cheap marginal tokens = a wider basin under rule 'le')
    gate_delta: float = 0.0
    draft_depth_norm: float = 0.0

    n_seen: int = field(default=0, init=False)
    n_admitted: int = field(default=0, init=False)
    history: list = field(default_factory=list, init=False)
    log_history: bool = True

    def decide(self, L: float, t: float) -> Decision:
        """Triage one request with uncertainty proxy ``L`` at time t."""
        E = self.meter.joules_per_request
        C = self.congestion.value()
        self.cost.observe(L, E, C)
        J = float(self.cost.J(L, E, C))
        if self.gate_delta > 0.0:
            # fourth objective term: the live speculative depth.  The
            # engine keeps draft_depth_norm at live/compiled depth —
            # 1.0 (deep drafts: high acceptance, cheap marginal
            # tokens) pulls J DOWN via (1 - d_norm), widening the
            # admission basin exactly when decode is running cheap
            J = ((J + self.gate_delta * (1.0 - self.draft_depth_norm))
                 / (1.0 + self.gate_delta))
        tau = self._scaled(float(self.threshold(t)))
        if not self.enabled:
            admit = True
        elif self.rule == "le":
            admit = J <= tau
        else:
            admit = J >= tau
        self.n_seen += 1
        self.n_admitted += int(admit)
        if isinstance(self.threshold, AdaptiveThreshold):
            self.threshold.observe(admit)
        d = Decision(admit=admit, J=J, tau=tau, L=L, E=E, C=C, t=t)
        if self.log_history:
            self.history.append(d)
        return d

    @property
    def admission_rate(self) -> float:
        return self.n_admitted / max(self.n_seen, 1)

    def _scaled(self, tau: float) -> float:
        """Apply the brownout scale so a scale < 1 always SHRINKS the
        admission basin regardless of rule direction (divide for 'ge',
        where admit means J >= tau)."""
        s = self.tau_scale
        if s == 1.0 or not self.enabled:
            return tau
        return tau * s if self.rule == "le" else tau / max(s, 1e-9)

    # -- middleware hooks (repro_torch.serving.api) ---------------------------
    def snapshot(self, t: float) -> tuple[float, float, float]:
        """(tau, e_norm, c_norm) at time ``t`` — the hook the in-graph
        gated path uses instead of per-request :meth:`decide`: the gated
        step takes the normalised meter/congestion scalars as traced
        inputs and applies the same J-vs-tau rule on device."""
        E = self.meter.joules_per_request
        C = self.congestion.value()
        self.cost.norm_e.update(E)
        self.cost.norm_c.update(C)
        # open-loop: a tau no J can violate, so the gate admits all
        # (up to the step's static capacity)
        tau = (self._scaled(float(self.threshold(t))) if self.enabled
               else (float("inf") if self.rule == "le"
                     else float("-inf")))
        return (tau, float(self.cost.norm_e(E)),
                float(self.cost.norm_c(C)))

    def peek(self, t: float) -> tuple[float, float, float]:
        """Side-effect-free view of ``(tau, e_norm, c_norm)`` at ``t``.

        Unlike :meth:`snapshot`, nothing is updated — not the cost
        normaliser bounds, not an adaptive threshold's PI integral —
        so external observers (the fleet router scoring candidate
        replicas) can read the closed-loop state without perturbing
        loops they don't own."""
        E = self.meter.joules_per_request
        C = self.congestion.value()
        if not self.enabled:
            tau = (float("inf") if self.rule == "le"
                   else float("-inf"))
        elif isinstance(self.threshold, AdaptiveThreshold):
            tau = self._scaled(float(self.threshold.preview(t)))
        else:
            tau = self._scaled(float(self.threshold(t)))
        return (tau, float(self.cost.norm_e(E)),
                float(self.cost.norm_c(C)))

    def observe_external(self, admits) -> None:
        """Fold admissions decided outside :meth:`decide` (the in-graph
        gate's mask) back into the closed-loop state, so admission-rate
        tracking and the adaptive threshold see every request."""
        for a in admits:
            a = bool(a)
            self.n_seen += 1
            self.n_admitted += int(a)
            if isinstance(self.threshold, AdaptiveThreshold):
                self.threshold.observe(a)

    def as_middleware(self):
        """This controller as pluggable serving middleware (the unified
        API's admission stage); see ``repro_torch.serving.api``."""
        from repro_torch.serving.api import AdmissionMiddleware
        return AdmissionMiddleware(self)


def gate_batch(L: torch.Tensor, tau: torch.Tensor | float, *,
               E: float, C: float, cost: CostModel,
               rule: str = "le") -> torch.Tensor:
    """Vectorised admission mask for a batch of requests.

    L [B] per-request uncertainty (entropy from the CUDA kernel); E/C
    are the shared meter/congestion scalars snapshotted on the host.
    Returns bool [B] on L's device: the early-exit serving step computes
    the proxy head, gates, and only the admitted bucket proceeds to the
    full model.
    """
    J = cost.J_batch(L, E, C)
    return (J <= tau) if rule == "le" else (J >= tau)
