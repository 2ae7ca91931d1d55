"""Replica health state machine.

::

                 crash                recover (until_s)        heal
    HEALTHY ───────────────▶ FAILED ───────────────▶ RECOVERING ──▶ HEALTHY
       │  degrade                                        ▲
       └───────────▶ DEGRADED ── heal ──▶ HEALTHY        │
                        │            crash               │
                        └────────────────▶ FAILED ───────┘

FAILED replicas are not routable and must not be revived by the
autoscaler (their capacity is gone, not parked); DEGRADED and
RECOVERING replicas stay routable but carry a service-time or
warm-up penalty.  ``until_s`` is the virtual time at which the
current non-healthy episode is scheduled to end — simulators schedule
a recovery event at that instant rather than polling.
"""
from __future__ import annotations

from dataclasses import dataclass

HEALTHY = "healthy"
DEGRADED = "degraded"
FAILED = "failed"
RECOVERING = "recovering"

HEALTH_STATES = (HEALTHY, DEGRADED, FAILED, RECOVERING)


@dataclass
class HealthState:
    """Mutable health record carried by a replica/worker."""

    status: str = HEALTHY
    until_s: float = 0.0
    slow_factor: float = 1.0
    n_crashes: int = 0
    n_degrades: int = 0

    @property
    def routable(self) -> bool:
        return self.status != FAILED

    @property
    def healthy(self) -> bool:
        return self.status == HEALTHY

    def fail(self, now: float, duration_s: float) -> None:
        self.status = FAILED
        self.until_s = now + duration_s
        self.slow_factor = 1.0
        self.n_crashes += 1

    def degrade(self, now: float, factor: float, duration_s: float) -> None:
        # A crash outranks a slowdown: don't resurrect a FAILED node
        # by marking it merely DEGRADED.
        if self.status == FAILED:
            return
        self.status = DEGRADED
        self.until_s = max(self.until_s, now + duration_s)
        self.slow_factor = max(self.slow_factor, float(factor))
        self.n_degrades += 1

    def recover(self, now: float, recovering_s: float = 0.0) -> None:
        """Leave FAILED/DEGRADED; optionally pass through RECOVERING."""
        self.slow_factor = 1.0
        if recovering_s > 0.0:
            self.status = RECOVERING
            self.until_s = now + recovering_s
        else:
            self.status = HEALTHY
            self.until_s = now

    def heal(self) -> None:
        self.status = HEALTHY
        self.slow_factor = 1.0
        self.until_s = 0.0

    def reset(self) -> None:
        self.heal()
        self.n_crashes = 0
        self.n_degrades = 0
