"""The port's failure model (``repro_torch.faults``) against the JAX
package's, on the CPU.

The chaos stories run over the sim fleet of both packages with one
``EnergyModel`` pinned on both sides: the same fault plans, retries,
rejections and reports, byte for byte (``json.dumps(...,
sort_keys=True)``; host arithmetic on the same numpy draws, so no
tolerance).  Then the reference's own claims (``tests/test_faults.py``)
on the port, less the disaggregated-serving ones, which wait for the
port of ``repro.disagg``.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.serving.api import (PATH_REJECT, InferRequest,  # noqa: E402
                                     request_expiry)

KINDS3 = ("direct", "dynamic-batch", "gated-in-graph")
STORIES = ("crash-storm", "kv-pressure", "slow-node", "seeded-storm")
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)


def report_json(report, pool) -> dict:
    """A fleet report as canonical JSON, with (rid, path, replica,
    t_finish, admitted) for every response."""
    where = {r.rid: rep.name for rep in pool for r in rep.server.responses}
    reqs = [(r.rid, r.path, where.get(r.rid), r.t_finish, r.admitted)
            for r in report.responses]
    return {k: json.dumps(v, sort_keys=True, default=str)
            for k, v in (("summary", report.summary),
                         ("per_replica", report.per_replica),
                         ("autoscaler_log", report.autoscaler_log),
                         ("requests", reqs))}


def _chaos_fleet(faults, fleet, ch, **kw):
    em = {"energy_model": TEM} if fleet is tfleet else {}
    pool = fleet.build_sim_fleet(ch.scenario.oracle, kinds=KINDS3, **em)
    sim = fleet.FleetSimulator(pool, fleet.EnergyAwareRouter(),
                               injector=faults.FaultInjector(ch.plan),
                               retry_policy=faults.RetryPolicy(),
                               brownout=faults.BrownoutController(), **kw)
    return sim, pool


# ---------------------------------------------------------------------------
# the reference against the port, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STORIES)
def test_chaos_story_equals_jax(name):
    jch = jfaults.make_chaos(name, 300, seed=0)
    tch = tfaults.make_chaos(name, 300, seed=0)
    assert tch.plan.to_json() == jch.plan.to_json()
    assert (tch.deadline_s, tch.description) == (jch.deadline_s,
                                                 jch.description)
    jsim, jpool = _chaos_fleet(jfaults, jfleet, jch)
    tsim, tpool = _chaos_fleet(tfaults, tfleet, tch)
    jrep = jsim.run(jch.requests())
    trep = tsim.run(tch.requests())
    assert report_json(trep, tpool) == report_json(jrep, jpool)
    assert ([r.telemetry.get("reason") for r in trep.responses]
            == [r.telemetry.get("reason") for r in jrep.responses])
    assert trep.summary["n_failures"] > 0
    assert sorted(r.rid for r in trep.responses) == list(range(300))


def test_seeded_plan_equals_jax():
    kw = dict(targets=["a", "b", "c"], horizon_s=10.0, n_events=6)
    jp = jfaults.FaultPlan.seeded(7, **kw)
    tp = tfaults.FaultPlan.seeded(7, **kw)
    assert tp.to_json() == jp.to_json()
    assert tp.signature() == jp.signature()
    assert tp.horizon == jp.horizon


# ---------------------------------------------------------------------------
# the reference's claims (tests/test_faults.py) on the port
# ---------------------------------------------------------------------------

def test_fault_plan_scripted_sorts_and_validates():
    plan = tfaults.FaultPlan.scripted([
        tfaults.FaultEvent(t=2.0, kind="crash", target="b"),
        tfaults.FaultEvent(t=1.0, kind="degrade", target="a", magnitude=2.5),
    ])
    assert [e.t for e in plan.events] == [1.0, 2.0]
    with pytest.raises(ValueError):
        tfaults.FaultEvent(t=-1.0, kind="crash")
    with pytest.raises(ValueError):
        tfaults.FaultEvent(t=0.0, kind="crash", duration_s=-0.1)


@pytest.mark.parametrize("bad, hint", [("crsh", "did you mean 'crash'"),
                                       ("link-flop", "link-flap")])
def test_unknown_fault_kind_suggests_nearest(bad, hint):
    with pytest.raises(ValueError, match=hint):
        tfaults.FaultEvent(t=0.0, kind=bad)


def test_seeded_plan_identical_per_seed():
    kw = dict(targets=["a", "b", "c"], horizon_s=10.0, n_events=6)
    p1 = tfaults.FaultPlan.seeded(42, **kw)
    p2 = tfaults.FaultPlan.seeded(42, **kw)
    assert p1.to_json() == p2.to_json()
    assert p1.signature() == p2.signature()
    assert len(p1.events) == 6
    assert all(e.kind in tfaults.FAULT_KINDS for e in p1.events)
    assert all(0.0 <= e.t <= 10.0 for e in p1.events)
    assert tfaults.FaultPlan.seeded(43, **kw).to_json() != p1.to_json()


def test_injector_drains_in_order():
    plan = tfaults.FaultPlan.scripted([
        tfaults.FaultEvent(t=1.0, kind="crash", target="a"),
        tfaults.FaultEvent(t=3.0, kind="degrade", target="b"),
    ])
    inj = tfaults.FaultInjector(plan)
    assert inj.next_t() == 1.0
    assert [e.t for e in inj.pop_due(2.0)] == [1.0]
    assert not inj.exhausted
    assert [e.t for e in inj.pop_due(5.0)] == [3.0]
    assert inj.exhausted
    inj.reset()
    assert inj.next_t() == 1.0


def test_health_state_machine_transitions():
    h = tfaults.HealthState()
    assert h.status == tfaults.HEALTHY and h.routable
    h.fail(1.0, 0.5)
    assert h.status == tfaults.FAILED and not h.routable
    assert h.n_crashes == 1
    h.degrade(1.1, 3.0, 1.0)
    assert h.status == tfaults.FAILED
    h.recover(1.5, recovering_s=0.25)
    assert h.status == tfaults.RECOVERING and h.routable
    h.heal()
    assert h.status == tfaults.HEALTHY and h.slow_factor == 1.0
    h.degrade(2.0, 2.0, 1.0)
    h.degrade(2.1, 3.0, 0.5)
    assert h.slow_factor == 3.0
    h.recover(3.0)
    assert h.status == tfaults.HEALTHY


def test_retry_policy_backoff_bounded():
    p = tfaults.RetryPolicy(max_retries=3, backoff_base_s=0.1,
                            backoff_mult=2.0, backoff_max_s=0.3)
    assert [p.allows(a) for a in (1, 2, 3, 4)] == [True, True, True, False]
    assert p.delay(1) == pytest.approx(0.1)
    assert p.delay(2) == pytest.approx(0.2)
    assert p.delay(3) == pytest.approx(0.3)
    assert p.delay(9) == pytest.approx(0.3)


def test_brownout_pressure_decays_and_recovers():
    b = tfaults.BrownoutController(half_life_s=1.0, sensitivity=1.0,
                                   min_scale=0.4)
    assert b.scale(0.0) == 1.0
    b.record(0.0, 4.0)
    s0 = b.scale(0.0)
    assert 0.4 <= s0 < 1.0
    assert b.scale(3.0) > s0
    assert b.scale(30.0) == pytest.approx(1.0, abs=1e-2)
    assert b.min_scale_seen == s0


@pytest.mark.parametrize("rule", ["le", "ge"])
def test_brownout_tightens_tau_via_scale(rule):
    ctrl = TController(threshold=TThreshold(tau0=1.0, tau_inf=0.5, k=0.5),
                       rule=rule)
    tau = ctrl.peek(0.0)[0]
    ctrl.tau_scale = 0.5
    want = 0.5 * tau if rule == "le" else tau / 0.5
    assert ctrl.peek(0.0)[0] == pytest.approx(want)


def test_request_expiry_reads_deadline_and_override():
    assert request_expiry(InferRequest(rid=0, arrival_s=1.0)) == float("inf")
    r2 = InferRequest(rid=1, arrival_s=1.0, deadline_s=0.5)
    assert request_expiry(r2) == pytest.approx(1.5)
    r3 = InferRequest(rid=2, arrival_s=9.0, deadline_s=0.5,
                      metadata={"expires_at": 1.5})
    assert request_expiry(r3) == pytest.approx(1.5)


def test_with_deadline_clones_trace():
    sc = tfleet.make_scenario("steady", 20, seed=0)
    dl = tfleet.with_deadline(sc, 0.8)
    assert all(r.deadline_s == 0.8 for r in dl.requests)
    assert all(r.deadline_s is None for r in sc.requests)
    assert [r.rid for r in dl.requests] == [r.rid for r in sc.requests]
    cleared = tfleet.with_deadline(dl, None)
    assert all(r.deadline_s is None for r in cleared.requests)


def test_expired_request_rejected_once_never_executed():
    sc = tfleet.make_scenario("steady", 40, seed=1)
    dl = tfleet.with_deadline(sc, 0.0)
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    rep = tfleet.FleetSimulator(pool, tfleet.EnergyAwareRouter()).run(
        dl.requests)
    assert sorted(r.rid for r in rep.responses) == list(range(40))
    assert all(r.path == PATH_REJECT for r in rep.responses)
    assert all(r.telemetry["reason"] == "deadline-expired"
               for r in rep.responses)
    assert rep.summary["n_expired"] == 40
    assert rep.summary["n_served"] == 0
    assert all(r.server.log.n == 0 for r in pool.replicas)


def test_queued_request_shed_at_expiry():
    sc = tfleet.make_scenario("steady", 10, seed=2)
    r = tfleet.make_sim_replica("b-0", "dynamic-batch", sc.oracle,
                                queue_window_s=10.0)
    r.start()
    r.push(InferRequest(rid=0, arrival_s=0.0, deadline_s=0.1,
                        label=int(sc.oracle.labels[0]), entropy_hint=0.2))
    assert [x.rid for x in r.server.shed_expired(5.0)] == [0]
    mine = [x for x in r.finish(6.0) if x.rid == 0]
    assert len(mine) == 1
    assert mine[0].path == PATH_REJECT


def test_crash_now_claws_back_inflight_and_wastes_joules():
    sc = tfleet.make_scenario("steady", 10, seed=3)
    r = tfleet.make_sim_replica("d-0", "direct", sc.oracle)
    r.start()
    req = sc.requests[0]
    done = [x for x in r.push(req) if x.rid == req.rid]
    assert done and done[0].t_finish > req.arrival_s
    mid = (req.arrival_s + done[0].t_finish) / 2
    report = r.crash(mid, duration_s=0.5)
    assert req.rid in report.lost_rids
    assert report.wasted_j > 0.0
    assert r.wasted_j == pytest.approx(report.wasted_j)
    assert r.server.log.n == 0
    assert not r.routable and not r.revivable
    r.recover(mid + 1.0)
    assert r.routable


def test_all_stopped_pool_rejects_with_reason_not_crash():
    sc = tfleet.make_scenario("steady", 30, seed=4)
    plan = tfaults.FaultPlan.scripted([
        tfaults.FaultEvent(t=0.0, kind="crash", target=f"{k}-{i}",
                           duration_s=1000.0)
        for i, k in enumerate(KINDS3)])
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    rep = tfleet.FleetSimulator(
        pool, tfleet.EnergyAwareRouter(),
        injector=tfaults.FaultInjector(plan),
        retry_policy=tfaults.RetryPolicy(max_retries=2)).run(sc.requests)
    assert sorted(r.rid for r in rep.responses) == list(range(30))
    assert all(r.path == PATH_REJECT for r in rep.responses)
    assert all(r.telemetry["reason"] == "retry-budget:no-routable-replica"
               for r in rep.responses)
    assert rep.summary["span_s"] > 0


def test_unmatched_kind_rejects_instead_of_hanging():
    sc = tfleet.make_scenario("steady", 4, seed=5)
    gen = [InferRequest(rid=99, arrival_s=0.0, kind="generate",
                        payload=np.zeros(4, np.int32))]
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    rep = tfleet.FleetSimulator(
        pool, tfleet.EnergyAwareRouter(),
        retry_policy=tfaults.RetryPolicy(max_retries=1)).run(
        sc.requests + gen)
    mine = [r for r in rep.responses if r.rid == 99]
    assert len(mine) == 1
    assert mine[0].path == PATH_REJECT
    assert mine[0].telemetry["reason"].startswith("retry-budget:")
    assert rep.summary["n_served"] == 4


def test_autoscaler_revives_parked_but_never_failed():
    sc = tfleet.make_scenario("steady", 10, seed=6)
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3).start()
    drained, crashed = pool.replicas[0], pool.replicas[1]
    drained.drain(0.0)
    crashed.crash(0.0, duration_s=10.0)
    assert drained.revivable and not crashed.revivable
    sca = tfleet.Autoscaler(hi_pressure_s=0.0, cooldown_s=0.0)
    sca._press = 1.0                  # force the revive branch
    assert sca.observe(1.0, pool) == [("revive", drained.name)]
    assert crashed.state != "active" and not crashed.routable


def test_by_name_suggests_nearest_replica():
    sc = tfleet.make_scenario("steady", 4, seed=7)
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    with pytest.raises(KeyError, match="did you mean 'direct-0'"):
        pool.by_name("direct0")


def test_chaos_registry_and_suggestion():
    assert set(tfaults.CHAOS_SCENARIOS) >= {"crash-storm", "link-flap",
                                            "crash-and-flap", "seeded-storm"}
    with pytest.raises(ValueError, match="did you mean 'crash-storm'"):
        tfaults.make_chaos("crash-strom", 10)


def test_crash_and_flap_serves_exactly_once():
    ch = tfaults.make_chaos("crash-and-flap", 400, seed=0)
    sim, _ = _chaos_fleet(tfaults, tfleet, ch)
    rep = sim.run(ch.requests())
    rids = [r.rid for r in rep.responses]
    assert sorted(rids) == list(range(400))
    assert len(set(rids)) == len(rids)
    assert rep.summary["served_frac"] >= 0.95
    assert rep.summary["n_failures"] == 2
    assert rep.summary["n_retries"] > 0
    rejected = [r for r in rep.responses if r.path == PATH_REJECT]
    assert all(r.telemetry.get("reason") for r in rejected)
    assert rep.summary["brownout_min_scale"] < 1.0


def test_chaos_plan_deterministic():
    p1 = tfaults.make_chaos("seeded-storm", 50, seed=7).plan
    p2 = tfaults.make_chaos("seeded-storm", 50, seed=7).plan
    assert p1.to_json() == p2.to_json()


def test_with_deadlines_stamps_chaos_trace():
    ch = tfaults.make_chaos("crash-storm", 20, seed=0)
    assert all(r.deadline_s == ch.deadline_s for r in ch.requests())
    again = tfaults.with_deadlines(ch.scenario, 9.0)
    assert all(r.deadline_s == 9.0 for r in again.requests)


def test_live_slow_node_is_a_no_op():
    """``degrade`` on a replica whose engine has no latency model (a
    live adapter) marks it degraded and slows nothing, as in the
    reference (``repro/fleet/replica.py:487-489``)."""
    class NoLatency:
        pass

    sc = tfleet.make_scenario("steady", 4, seed=8)
    r = tfleet.make_sim_replica("d-0", "direct", sc.oracle)
    r.server.engine = NoLatency()
    r.degrade(0.0, 3.0, 1.0)
    assert r.health.status == tfaults.DEGRADED
    assert r._base_latency is None
