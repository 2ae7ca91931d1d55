"""Decaying admission threshold tau(t) — paper Eq. (3).

    tau(t) = tau_inf + (tau_0 - tau_inf) * exp(-k * t)

Permissive at startup (exploration, "folding"), strict once the system
has settled into an acceptable basin.  ``AdaptiveThreshold`` is the
beyond-paper closed-loop extension: a PI controller trims tau_inf to
track a target admission rate (the paper's Future Work suggests an RL
agent for this; a PI loop is the auditable production version).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class DecayingThreshold:
    tau0: float = 1.0           # initial (permissive) threshold
    tau_inf: float = 0.35       # asymptotic (strict) threshold
    k: float = 0.05             # decay rate [1/s or 1/request]

    def __call__(self, t) -> float:
        """tau at time t (scalar, numpy array or tensor)."""
        if isinstance(t, (int, float)):
            return self.tau_inf + (self.tau0 - self.tau_inf) * math.exp(
                -self.k * t)
        exp = torch.exp if isinstance(t, torch.Tensor) else np.exp
        return self.tau_inf + (self.tau0 - self.tau_inf) * exp(-self.k * t)

    def settled(self, t: float, rel_tol: float = 0.05) -> bool:
        """True once tau(t) is within rel_tol of tau_inf ("folded")."""
        span = abs(self.tau0 - self.tau_inf)
        if span == 0:
            return True
        return abs(self(t) - self.tau_inf) <= rel_tol * span


@dataclass
class AdaptiveThreshold:
    """Closed-loop tau: Eq. (3) decay + PI trim on the admission rate.

    error = target_admission_rate - observed_rate (EWMA); the integral
    term shifts tau_inf so the system holds the operator's energy
    budget even as the workload's J(x) distribution drifts.
    """
    base: DecayingThreshold = field(default_factory=DecayingThreshold)
    target_rate: float = 0.6
    kp: float = 0.5
    ki: float = 0.05
    ewma: float = 0.1           # admission-rate smoothing

    _rate: float = field(default=1.0, init=False)
    _integral: float = field(default=0.0, init=False)

    def observe(self, admitted: bool) -> None:
        x = 1.0 if admitted else 0.0
        self._rate = (1 - self.ewma) * self._rate + self.ewma * x

    def observe_rate(self, rate: float) -> None:
        self._rate = (1 - self.ewma) * self._rate + self.ewma * rate

    @property
    def admission_rate(self) -> float:
        return self._rate

    def __call__(self, t: float) -> float:
        tau = self.preview(t)
        err = self.target_rate - self._rate
        self._integral = max(-10.0, min(10.0, self._integral + err))
        return tau

    def preview(self, t: float) -> float:
        """tau(t) WITHOUT advancing the PI integral — the single
        source of the PI law; ``__call__`` delegates here and then
        commits the integral.  External observers (the fleet router)
        use this so scoring never perturbs the loop."""
        err = self.target_rate - self._rate
        # rate too low -> loosen (raise tau); too high -> tighten
        integ = max(-10.0, min(10.0, self._integral + err))
        return self.base(t) + self.kp * err + self.ki * integ
