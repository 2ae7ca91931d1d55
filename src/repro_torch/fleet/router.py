"""Request routing across the replica fleet.

The headline policy is :class:`EnergyAwareRouter`: it scores every
routable replica as

    score = utility / (marginal_energy x congestion)

with marginal energy from the replica's closed-loop EnergyMeter EWMA
(analytic prior before traffic) and congestion from the replica's
backlog pressure relative to the request's SLO.  Pressure is the
protocol-level ``EnginePort.pressure(now)`` signal, so the same
policies route oracle-backed sim replicas and live-engine replicas
(``build_live_fleet``) without knowing which they hold.  Replicas are
visited in score order and the request lands in the FIRST ACCEPTABLE
BASIN — acceptable meaning the replica's own controller snapshot
satisfies ``J <= tau(t)`` — following the paper's protein-folding
framing: settle into an acceptable local minimum rather than pursue a
global optimum whose path is congested.

This is what turns the paper's offline Table-2 ORT-vs-Triton boundary
into a live decision: at sparse traffic the direct replica's EWMA is
the cheapest basin; as load rises its backlog inflates the congestion
term while the batch replica's fills amortise its fixed cost, and the
crossover emerges from the closed-loop signals themselves (see
the JAX package's ``benchmarks/fleet_boundary.py``).

Ablation baselines: :class:`StaticRouter` (open-loop pin),
:class:`RoundRobinRouter`, :class:`LeastLoadedRouter`.

Failure handling lives one layer up: routers only ever see the
ROUTABLE list (``state == ACTIVE`` and health not FAILED — see
``repro_torch.faults.health``).  When that list is empty the fleet
simulator does NOT call ``route``; it requeues the request with
virtual-time backoff and, once the retry budget is spent, rejects it
with reason ``no-routable-replica`` — ``_require``'s RuntimeError is
a programming-error guard, not a serving-path outcome.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

from repro_torch.fleet.replica import Replica


@runtime_checkable
class Router(Protocol):
    def route(self, req, replicas: list[Replica],
              now: float) -> Replica: ...


def _require(replicas: list[Replica]) -> None:
    if not replicas:
        raise RuntimeError("no routable replicas in the fleet")


@dataclass
class StaticRouter:
    """Open-loop baseline: pin everything to one replica (by index into
    the routable list)."""
    index: int = 0

    def route(self, req, replicas, now):
        _require(replicas)
        return replicas[min(self.index, len(replicas) - 1)]


@dataclass
class RoundRobinRouter:
    """Load-blind, energy-blind rotation."""
    _i: int = field(default=0, init=False)

    def route(self, req, replicas, now):
        _require(replicas)
        r = replicas[self._i % len(replicas)]
        self._i += 1
        return r


@dataclass
class LeastLoadedRouter:
    """Congestion-aware, energy-blind: minimum backlog pressure."""

    def route(self, req, replicas, now):
        _require(replicas)
        return min(replicas,
                   key=lambda r: (r.pressure(now),
                                  r.load().queue_depth, r.name))


@dataclass
class EnergyAwareRouter:
    """utility / (marginal energy x congestion), first acceptable basin.

    ``slo_s`` scales backlog seconds into the congestion factor; a
    request carrying ``metadata['slo_s']`` (multi-tenant scenarios)
    overrides it, so latency-tolerant tenants tolerate deeper basins.
    """
    slo_s: float = 0.25
    history: list = field(default_factory=list, init=False)
    log_history: bool = False
    tracer: object = None              # telemetry.trace recorder, optional

    def congestion(self, replica: Replica, now: float,
                   slo_s: float) -> float:
        return 1.0 + replica.pressure(now) / max(slo_s, 1e-6)

    def score(self, replica: Replica, now: float, slo_s: float) -> float:
        e = max(replica.joules_per_request(), 1e-9)
        return replica.utility / (e * self.congestion(replica, now,
                                                      slo_s))

    def acceptable(self, replica: Replica, now: float) -> bool:
        """The basin test: the replica's OWN closed-loop state must
        clear its threshold.  Open-loop controllers return tau=inf, so
        every basin is acceptable and pure score order decides.  Uses
        the side-effect-free ``peek`` — scoring a candidate must not
        perturb a loop the request may never enter."""
        ctrl = replica.controller
        if ctrl is None:
            return True
        tau, e_norm, c_norm = ctrl.peek(now)
        w = ctrl.cost.weights
        denom = max(w.beta + w.gamma, 1e-9)
        J = (w.beta * e_norm + w.gamma * c_norm) / denom
        # honour the controller's own admission direction (rule='ge'
        # is the paper's literal Eq. 2 reading; see controller.py)
        return J <= tau if ctrl.rule == "le" else J >= tau

    def route(self, req, replicas, now):
        _require(replicas)
        slo = float(getattr(req, "metadata", {}).get("slo_s", self.slo_s)
                    if getattr(req, "metadata", None) else self.slo_s)
        ranked = sorted(replicas,
                        key=lambda r: self.score(r, now, slo),
                        reverse=True)
        chosen = None
        for r in ranked:
            if self.acceptable(r, now):
                chosen = r
                break
        if chosen is None:           # every basin violates tau: take the
            chosen = ranked[0]       # least-bad one rather than dropping
        if self.log_history:
            self.history.append(
                (now, req.rid, chosen.name,
                 [round(self.score(r, now, slo), 4) for r in ranked]))
        if self.tracer is not None and self.tracer.enabled:
            # decision instant with the full scored candidate list —
            # guarded so untraced runs never pay the re-scoring cost
            self.tracer.event(
                "route", now, resource="router", rid=req.rid,
                chosen=chosen.name,
                scores={r.name: round(self.score(r, now, slo), 4)
                        for r in ranked})
        return chosen


ROUTERS = {
    "energy-aware": EnergyAwareRouter,
    "round-robin": RoundRobinRouter,
    "least-loaded": LeastLoadedRouter,
    "static": StaticRouter,
}


def make_router(name: str, **kw) -> Router:
    if name not in ROUTERS:
        raise ValueError(f"unknown routing policy {name!r}; known: "
                         f"{sorted(ROUTERS)}")
    return ROUTERS[name](**kw)
