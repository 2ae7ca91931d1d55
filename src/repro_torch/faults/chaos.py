"""Chaos scenario suite: a traffic trace + a fault plan + deadlines.

Each :class:`ChaosScenario` bundles a ``repro_torch.fleet.scenarios``
traffic shape with a :class:`~repro_torch.faults.plan.FaultPlan` and a
default per-request deadline, so the JAX package's
``benchmarks/chaos_recovery.py`` and ``python -m repro_torch.launch.serve
--fleet --chaos <name>`` run the exact same reproducible failure story.  Target names follow the default sim
fleet built by :func:`repro_torch.fleet.pool.build_sim_fleet` —
``direct-0``, ``dynamic-batch-1``, ``gated-in-graph-2``.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass

from repro_torch.faults.plan import (FAULT_CRASH, FAULT_DEGRADE,
                                     FAULT_KV_SPIKE, FAULT_LINK_FLAP,
                                     FaultEvent, FaultPlan)
from repro_torch.fleet.scenarios import Scenario, make_scenario, with_deadline

# Default sim-fleet replica names (build_sim_fleet with the first
# three REPLICA_KINDS).
_R0, _R1, _R2 = "direct-0", "dynamic-batch-1", "gated-in-graph-2"


def with_deadlines(scenario: Scenario, deadline_s: float) -> Scenario:
    """Return a copy of ``scenario`` whose requests all carry
    ``deadline_s`` (relative to their own arrival)."""
    return with_deadline(scenario, float(deadline_s))


@dataclass(frozen=True)
class ChaosScenario:
    """One named, fully reproducible failure story."""

    name: str
    scenario: Scenario
    plan: FaultPlan
    deadline_s: float
    description: str = ""

    def requests(self) -> list:
        return with_deadlines(self.scenario, self.deadline_s).requests


def crash_storm(n: int = 1200, *, qps: float = 60.0,
                seed: int = 0) -> ChaosScenario:
    """Two replicas crash back-to-back mid-trace; stranded work must
    fail over through the router and recover before the horizon."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    plan = FaultPlan.scripted([
        FaultEvent(t=3.0, kind=FAULT_CRASH, target=_R1, duration_s=2.0),
        FaultEvent(t=4.0, kind=FAULT_CRASH, target=_R2, duration_s=1.5),
    ])
    return ChaosScenario(
        name="crash-storm", scenario=sc, plan=plan, deadline_s=2.0,
        description="two replica crashes back-to-back under steady load")


def slow_node(n: int = 1200, *, qps: float = 60.0,
              seed: int = 0) -> ChaosScenario:
    """One replica's service times triple for a window — the router
    should steer around it and brownout should barely move."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    plan = FaultPlan.scripted([
        FaultEvent(t=3.0, kind=FAULT_DEGRADE, target=_R0,
                   duration_s=4.0, magnitude=3.0),
    ])
    return ChaosScenario(
        name="slow-node", scenario=sc, plan=plan, deadline_s=2.0,
        description="3x service-time degradation on one replica")


def kv_pressure(n: int = 1200, *, qps: float = 60.0,
                seed: int = 0) -> ChaosScenario:
    """A KV-pool exhaustion spike inflates one replica's pressure so
    the router and autoscaler treat it as congested."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    plan = FaultPlan.scripted([
        FaultEvent(t=3.0, kind=FAULT_KV_SPIKE, target=_R2,
                   duration_s=3.0, magnitude=0.5),
    ])
    return ChaosScenario(
        name="kv-pressure", scenario=sc, plan=plan, deadline_s=2.0,
        description="KV-pool exhaustion spike on one replica")


def link_flap(n: int = 48, *, qps: float = 24.0,
              seed: int = 0) -> ChaosScenario:
    """Transfer-link outage for the disagg path: in-flight KV handoffs
    are dropped and must be retransmitted after the outage."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    plan = FaultPlan.scripted([
        FaultEvent(t=1.0, kind=FAULT_LINK_FLAP, target="link",
                   duration_s=0.5, magnitude=4.0),
    ])
    return ChaosScenario(
        name="link-flap", scenario=sc, plan=plan, deadline_s=5.0,
        description="transfer-link outage drops in-flight KV handoffs")


def crash_and_flap(n: int = 1200, *, qps: float = 60.0,
                   seed: int = 0) -> ChaosScenario:
    """The CI acceptance story: a replica crash plus a link flap in
    the same window — the fleet must serve >= 95% of in-deadline
    requests exactly once, with every stranded request retried or
    rejected-with-reason."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    plan = FaultPlan.scripted([
        FaultEvent(t=3.0, kind=FAULT_CRASH, target=_R1, duration_s=2.0),
        FaultEvent(t=3.5, kind=FAULT_LINK_FLAP, target="link",
                   duration_s=0.5, magnitude=4.0),
    ])
    return ChaosScenario(
        name="crash-and-flap", scenario=sc, plan=plan, deadline_s=2.0,
        description="scripted replica crash + transfer-link flap")


def seeded_storm(n: int = 1200, *, qps: float = 60.0,
                 seed: int = 7) -> ChaosScenario:
    """Seeded-random faults over the whole trace — the determinism
    property test's subject: same seed, byte-identical schedule."""
    sc = make_scenario("steady", n, qps=qps, seed=seed)
    span = sc.requests[-1].arrival_s if sc.requests else 10.0
    plan = FaultPlan.seeded(seed, [_R0, _R1, _R2],
                            horizon_s=max(1.0, 0.8 * span), n_events=6)
    return ChaosScenario(
        name="seeded-storm", scenario=sc, plan=plan, deadline_s=2.0,
        description=f"6 seeded-random faults (seed={seed})")


CHAOS_SCENARIOS = {
    "crash-storm": crash_storm,
    "slow-node": slow_node,
    "kv-pressure": kv_pressure,
    "link-flap": link_flap,
    "crash-and-flap": crash_and_flap,
    "seeded-storm": seeded_storm,
}


def make_chaos(name: str, n: int = 1200, *, qps: float | None = None,
               seed: int = 0, **kw) -> ChaosScenario:
    if name not in CHAOS_SCENARIOS:
        msg = f"unknown chaos scenario {name!r}"
        close = difflib.get_close_matches(name, CHAOS_SCENARIOS, n=1)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        raise ValueError(msg + f"; known: {sorted(CHAOS_SCENARIOS)}")
    if qps is not None:
        kw["qps"] = qps
    return CHAOS_SCENARIOS[name](n, seed=seed, **kw)
