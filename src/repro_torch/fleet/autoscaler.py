"""Hysteresis autoscaler — drain and revive replicas from load and
energy-per-request trends.

Two closed-loop signals, two watermarks, one cooldown:

  - **pressure** (EWMA of mean backlog seconds across active
    replicas): above ``hi_pressure_s`` -> revive the most efficient
    stopped replica; the gap between the watermarks is the hysteresis
    band that keeps the scaler from flapping.
  - **marginal joules/request** (windowed delta of fleet energy over
    requests served, idle burn included): when pressure is below
    ``lo_pressure_s`` AND the marginal cost has drifted
    ``jpr_margin`` above the best level ever observed — i.e. idle
    power now dominates each request — the least efficient active
    replica is drained through the ordinary request path
    (``EnginePort.drain`` flushes its queue; nothing is dropped).

``min_active`` bounds scale-down; ``cooldown_s`` bounds action rate.
Every action is recorded in ``log`` with the signal values that
triggered it, so fleet runs stay auditable.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Autoscaler:
    hi_pressure_s: float = 0.5     # revive watermark (backlog seconds)
    lo_pressure_s: float = 0.05    # drain watermark
    jpr_margin: float = 0.10       # drain only if jpr > best*(1+margin)
    cooldown_s: float = 2.0
    min_active: int = 1
    ewma: float = 0.3
    min_window: int = 10           # requests per marginal-jpr sample

    _press: float = field(default=0.0, init=False)
    _jpr: float = field(default=0.0, init=False)
    _jpr_best: float = field(default=float("inf"), init=False)
    _last_e: float = field(default=0.0, init=False)
    _last_n: int = field(default=0, init=False)
    _last_action_t: float = field(default=float("-inf"), init=False)
    log: list = field(default_factory=list, init=False)

    def observe(self, now: float, pool) -> list[tuple]:
        """Update signal EWMAs from the pool; maybe drain/revive one
        replica.  Returns the actions taken (also appended to ``log``)."""
        active = pool.routable()
        if active:
            press = sum(r.pressure(now) for r in active) / len(active)
            self._press += self.ewma * (press - self._press)

        e, n = pool.energy_j(), pool.n_served()
        if n - self._last_n >= self.min_window:
            jpr = (e - self._last_e) / (n - self._last_n)
            self._last_e, self._last_n = e, n
            self._jpr = (jpr if self._jpr == 0.0
                         else self._jpr + self.ewma * (jpr - self._jpr))
            self._jpr_best = min(self._jpr_best, self._jpr)

        actions = []
        if now - self._last_action_t < self.cooldown_s:
            return actions

        # only parked capacity may be woken — a FAILED replica is gone
        # until its own scheduled recovery, not the scaler's to revive
        stopped = [r for r in pool.replicas
                   if getattr(r, "revivable", not r.routable)]
        if self._press > self.hi_pressure_s and stopped:
            r = min(stopped, key=lambda r: r.joules_per_request())
            pool.revive(r)
            actions.append(("revive", r.name))
        elif (self._press < self.lo_pressure_s
              and len(active) > self.min_active
              and self._jpr_best < float("inf")
              and self._jpr > self._jpr_best * (1 + self.jpr_margin)):
            # drain the least efficient active replica (its queued
            # work flushes through EnginePort.drain — nothing is lost)
            r = max(active, key=lambda r: r.joules_per_request())
            pool.drain(r, now)
            actions.append(("drain", r.name))

        for kind, name in actions:
            self._last_action_t = now
            self.log.append({
                "t": round(now, 4), "action": kind, "replica": name,
                "pressure_ewma_s": round(self._press, 4),
                "jpr_ewma": round(self._jpr, 4),
                "jpr_best": round(self._jpr_best, 4),
                "n_active": len(pool.routable()),
            })
        return actions
