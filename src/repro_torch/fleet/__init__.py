"""``repro_torch.fleet`` — energy-aware multi-replica serving.

The layer above the four execution paths: a :class:`ReplicaPool` of
heterogeneous replicas (each a full ``Server`` with its own admission
controller and energy meter), an :class:`EnergyAwareRouter` that makes
the paper's ORT-vs-Triton efficiency boundary a per-request runtime
decision, a hysteresis :class:`Autoscaler` that drains and revives
replicas from load and energy-per-request trends, and a scenario suite
(diurnal / flash-crowd / multi-tenant / adversarial flood) driven by
an event-driven fleet simulator with fleet-level carbon accounting.

Invariants of the layer (what the pieces may and may not touch):

- **A replica is a whole server.**  Each :class:`Replica` wraps a full
  ``repro_torch.serving.api.Server`` with its OWN admission controller and
  energy meter — fleet policies never reach inside a replica's
  admission decisions or engine state; they only observe
  (``pressure(now)``, energy EWMAs) and route.
- **Pressure semantics.**  ``pressure(now)`` is a replica's
  side-effect-free backlog signal (queued + in-flight work scaled by
  modelled service rate) and is part of the ``EnginePort`` protocol
  itself — every engine (oracle, sim, live adapter) reports it
  uniformly, with a ``LoadState``-derived default for engines that
  predate the extension.  The router and autoscaler may poll it at
  any time; polling must never advance the replica's clock or queues.
- **One batching model.**  The sim engines wrap the REAL scheduling
  primitives (``DirectPath``/``DynamicBatcher`` and the
  ``BatchQueue``/``ServiceLine``/``SlotClock``/gate cores) — the fleet
  never re-implements window/size flush or free-at serialisation, so
  fleet sweeps and the Table-2 benchmark measure one scheduler.
- **Routing is per-request, scaling is hysteretic.**  The
  :class:`EnergyAwareRouter` picks the first acceptable basin by
  utility/(marginal-energy x congestion) against tau(t) at each
  arrival; the :class:`Autoscaler` drains/revives replicas only on
  sustained pressure + marginal-joules trends (never on a single
  sample) and logs every action for audit.
- **One clock, one carbon ledger.**  ``FleetSimulator`` owns the
  event clock and the fleet-level :class:`CarbonTracker`; replicas
  report node-level active+idle energy into it and never meter carbon
  themselves.

Quickstart::

    from repro_torch.fleet import (FleetSimulator, build_sim_fleet,
                                   EnergyAwareRouter, flash_crowd)

    sc = flash_crowd(2000, qps=40.0, seed=0)
    pool = build_sim_fleet(sc.oracle,
                           kinds=("direct", "dynamic-batch",
                                  "gated-in-graph"))
    report = FleetSimulator(pool, EnergyAwareRouter()).run(sc.requests)
    print(report.summary["joules_per_request"], report.carbon)

or from the CLI: ``python -m repro_torch.launch.serve --fleet``.
"""
from repro_torch.fleet.autoscaler import Autoscaler
from repro_torch.fleet.pool import (LIVE_CLASSIFIER_KINDS,
                                    LIVE_REPLICA_KINDS, FleetReport,
                                    FleetSimulator, ReplicaPool,
                                    build_live_fleet, build_sim_fleet,
                                    make_live_replica)
from repro_torch.fleet.replica import (ACTIVE, REPLICA_KINDS, STOPPED,
                                       Replica, SimBatchEngine,
                                       SimContinuousEngine, SimDirectEngine,
                                       SimGatedEngine, make_sim_replica)
from repro_torch.fleet.router import (ROUTERS, EnergyAwareRouter,
                                      LeastLoadedRouter, RoundRobinRouter,
                                      Router, StaticRouter, make_router)
from repro_torch.fleet.scenarios import (DEFAULT_TENANTS, GENERATE_SCENARIOS,
                                         SCENARIOS, Scenario, diurnal,
                                         flash_crowd, from_trace, long_decode,
                                         low_confidence_flood,
                                         make_generate_scenario, make_scenario,
                                         multi_tenant, prompt_burst, steady,
                                         with_deadline, with_payloads)

__all__ = [
    # pool / simulator
    "FleetReport", "FleetSimulator", "ReplicaPool",
    "LIVE_CLASSIFIER_KINDS", "LIVE_REPLICA_KINDS",
    "build_live_fleet", "build_sim_fleet", "make_live_replica",
    # replicas
    "ACTIVE", "STOPPED", "REPLICA_KINDS", "Replica",
    "SimBatchEngine", "SimContinuousEngine", "SimDirectEngine",
    "SimGatedEngine", "make_sim_replica",
    # routing
    "ROUTERS", "Router", "EnergyAwareRouter", "LeastLoadedRouter",
    "RoundRobinRouter", "StaticRouter", "make_router",
    # scaling
    "Autoscaler",
    # scenarios
    "DEFAULT_TENANTS", "GENERATE_SCENARIOS", "SCENARIOS", "Scenario",
    "diurnal", "flash_crowd", "from_trace", "long_decode",
    "low_confidence_flood", "make_generate_scenario", "make_scenario",
    "multi_tenant", "prompt_burst", "steady", "with_deadline",
    "with_payloads",
]
