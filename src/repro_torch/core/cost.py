"""Per-request cost functional J(x) — paper Eq. (1).

    J(x) = alpha * L(x) + beta * E(x) + gamma * C(x)

L(x): uncertainty proxy (softmax entropy / 1-confidence of the proxy
head); E(x): marginal energy (EWMA joules/request, from EnergyMeter);
C(x): congestion penalty (queue depth, recent P95 latency, batch fill).

Components live on wildly different scales (nats vs joules vs queue
depth), so each is normalised by a running min/max window before
weighting — this keeps (alpha, beta, gamma) interpretable policy knobs
as the paper intends ("performance priority -> raise alpha/gamma;
ecology priority -> raise beta").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Normalizer:
    """Running [lo, hi] -> [0, 1] squash with EWMA-tracked bounds."""
    ewma: float = 0.02
    lo: float = 0.0
    hi: float = 1.0
    _seen: bool = field(default=False, init=False)

    def update(self, x: float) -> None:
        x = float(x)
        if not self._seen:
            self.lo, self.hi = x, x + 1e-9
            self._seen = True
            return
        # instant expansion (a new extreme is immediately usable) ...
        self.lo = min(self.lo, x)
        self.hi = max(self.hi, x)
        # ... slow contraction so stale extremes eventually decay
        c = self.ewma * 0.1
        self.lo += c * (x - self.lo)
        self.hi -= c * (self.hi - x)
        if self.hi - self.lo < 1e-9:
            self.hi = self.lo + 1e-9

    def __call__(self, x):
        span = max(self.hi - self.lo, 1e-9)
        z = (x - self.lo) / span
        if isinstance(z, float):
            return min(max(z, 0.0), 1.0)
        if isinstance(z, torch.Tensor):
            return z.clamp(0.0, 1.0)
        return np.clip(z, 0.0, 1.0)


@dataclass
class CostWeights:
    alpha: float = 1.0          # uncertainty / utility weight
    beta: float = 1.0           # marginal-energy weight
    gamma: float = 1.0          # congestion weight

    @classmethod
    def performance_priority(cls) -> "CostWeights":
        return cls(alpha=1.5, beta=0.5, gamma=1.5)

    @classmethod
    def ecology_priority(cls) -> "CostWeights":
        return cls(alpha=0.7, beta=2.0, gamma=1.0)


@dataclass
class CostModel:
    weights: CostWeights = field(default_factory=CostWeights)
    norm_l: Normalizer = field(default_factory=Normalizer)
    norm_e: Normalizer = field(default_factory=Normalizer)
    norm_c: Normalizer = field(default_factory=Normalizer)

    def observe(self, L: float, E: float, C: float) -> None:
        self.norm_l.update(L)
        self.norm_e.update(E)
        self.norm_c.update(C)

    def J(self, L, E, C):
        """Cost for one request (works on floats, numpy arrays or tensors)."""
        w = self.weights
        denom = max(w.alpha + w.beta + w.gamma, 1e-9)
        return (w.alpha * self.norm_l(L) + w.beta * self.norm_e(E)
                + w.gamma * self.norm_c(C)) / denom

    def J_batch(self, L: torch.Tensor, E: float, C: float) -> torch.Tensor:
        """Vectorised J over a batch sharing the same E/C state."""
        return self.J(L, torch.full_like(L, E), torch.full_like(L, C))
