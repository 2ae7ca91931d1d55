"""Brownout: sustained failure pressure tightens τ(t).

The paper's closed loop adapts the admission threshold to *traffic*;
brownout extends it to *capacity*.  Each fault/retry/expiry feeds an
exponentially-decaying pressure accumulator; the resulting scale
``1 / (1 + sensitivity * pressure)`` (floored at ``min_scale``) is
applied multiplicatively to every admission controller's τ.  For the
``'le'`` rule (admit when entropy ≤ τ) a scale < 1 shrinks the
admission basin, so load is shed *before* queues melt — the
first-acceptable-basin rule applied to degraded capacity.  When
faults stop, the pressure decays and τ relaxes back on its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BrownoutController:
    """Exponentially-decaying failure-pressure → τ scale."""

    half_life_s: float = 2.0
    sensitivity: float = 0.5
    min_scale: float = 0.4

    _pressure: float = field(default=0.0, init=False, repr=False)
    _t: float = field(default=0.0, init=False, repr=False)
    min_scale_seen: float = field(default=1.0, init=False)
    n_events: int = field(default=0, init=False)

    def _decay_to(self, now: float) -> None:
        dt = max(0.0, now - self._t)
        if dt > 0.0 and self.half_life_s > 0.0:
            self._pressure *= 0.5 ** (dt / self.half_life_s)
        self._t = max(self._t, now)

    def record(self, now: float, weight: float = 1.0) -> None:
        """Feed one failure-pressure unit (fault, retry, expiry)."""
        self._decay_to(now)
        self._pressure += float(weight)
        self.n_events += 1

    def pressure(self, now: float) -> float:
        self._decay_to(now)
        return self._pressure

    def scale(self, now: float) -> float:
        """Current τ multiplier in ``[min_scale, 1]``."""
        p = self.pressure(now)
        s = max(self.min_scale, 1.0 / (1.0 + self.sensitivity * p))
        self.min_scale_seen = min(self.min_scale_seen, s)
        return s

    def reset(self) -> None:
        self._pressure = 0.0
        self._t = 0.0
        self.min_scale_seen = 1.0
        self.n_events = 0
