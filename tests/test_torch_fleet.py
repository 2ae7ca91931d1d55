"""The port's fleet layer (``repro_torch.fleet``) against the JAX
package's, on the CPU.

The sim fleet is host arithmetic over the same numpy draws, so the
same scenario through the same routers gives the reference's report
byte for byte (``json.dumps(..., sort_keys=True)``; no tolerance), with
one ``EnergyModel`` pinned on both sides (the port's default holds the
H100's constants, the reference's a TPU's).  Then the reference's own
claims (``tests/test_fleet.py``) on the port, and the live fleet over a
small DistilBERT carried across from the reference's init, with both
packages' walltimes pinned to one deterministic counter: the same
routing and admission per request, predictions equal, entropy within
1e-5.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import fleet as jfleet  # noqa: E402
from repro.core import AdmissionController as JController  # noqa: E402
from repro.core import DecayingThreshold as JThreshold  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.models import distilbert as jdb  # noqa: E402
from repro.serving import adapters as jadapters  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.kernels import entropy as tent  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import adapters as tadapters  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

KINDS3 = ("direct", "dynamic-batch", "gated-in-graph")
POLICIES = ("energy-aware", "round-robin", "least-loaded", "static")
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)
TRACE_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                             "trace_small.json")


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


def per_request(report, pool) -> list:
    """(rid, path, replica, t_finish, admitted) for every response; a
    fleet-minted rejection has no replica."""
    where = {r.rid: rep.name for rep in pool for r in rep.server.responses}
    return [(r.rid, r.path, where.get(r.rid), r.t_finish, r.admitted)
            for r in report.responses]


def report_json(report, pool) -> dict:
    return {"summary": _dumps(report.summary),
            "per_replica": _dumps(report.per_replica),
            "autoscaler_log": _dumps(report.autoscaler_log),
            "requests": _dumps(per_request(report, pool))}


def _sim(pkg, sc, router, *, autoscale=False, kinds=KINDS3,
         controller_factory=None):
    """One sim-fleet run of either package, the port's on the
    reference's energy constants."""
    kw = {"energy_model": TEM} if pkg is tfleet else {}
    pool = pkg.build_sim_fleet(sc.oracle, kinds=kinds,
                               controller_factory=controller_factory, **kw)
    sim = pkg.FleetSimulator(pool, router,
                             autoscaler=pkg.Autoscaler() if autoscale
                             else None)
    return sim.run(sc.requests), pool


def _run(sc, router, *, controller_factory=None):
    """The port's sim fleet on its own default constants, as the
    reference's tests run theirs."""
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3,
                                  controller_factory=controller_factory)
    return tfleet.FleetSimulator(pool, router).run(sc.requests), pool


# ---------------------------------------------------------------------------
# the reference against the port, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("autoscale", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_sim_fleet_report_equals_jax(policy, autoscale):
    jsc = jfleet.flash_crowd(800, qps=50.0, seed=4)
    tsc = tfleet.flash_crowd(800, qps=50.0, seed=4)
    jrep, jpool = _sim(jfleet, jsc, jfleet.make_router(policy),
                       autoscale=autoscale)
    trep, tpool = _sim(tfleet, tsc, tfleet.make_router(policy),
                       autoscale=autoscale)
    assert report_json(trep, tpool) == report_json(jrep, jpool)
    assert trep.carbon == jrep.carbon
    if autoscale and policy == "energy-aware":
        assert trep.autoscaler_log          # the scaler acted


@pytest.mark.parametrize("name", sorted(tfleet.SCENARIOS))
def test_scenarios_equal_jax(name):
    j = jfleet.make_scenario(name, 300, seed=3)
    t = tfleet.make_scenario(name, 300, seed=3)
    assert (j.name, j.description, j.slo_s) == (t.name, t.description,
                                                t.slo_s)
    assert ([(r.rid, r.arrival_s, r.entropy_hint, r.label, r.metadata)
             for r in j.requests]
            == [(r.rid, r.arrival_s, r.entropy_hint, r.label, r.metadata)
                for r in t.requests])
    for f in ("full_pred", "proxy_pred", "entropy", "labels"):
        np.testing.assert_array_equal(getattr(t.oracle, f),
                                      getattr(j.oracle, f))


@pytest.mark.parametrize("name", sorted(tfleet.GENERATE_SCENARIOS))
def test_generate_scenarios_equal_jax(name):
    j = jfleet.make_generate_scenario(name, 12, seed=2, vocab=64)
    t = tfleet.make_generate_scenario(name, 12, seed=2, vocab=64)
    assert ([(r.rid, r.arrival_s, r.kind, r.max_new,
              np.asarray(r.payload).tolist()) for r in j.requests]
            == [(r.rid, r.arrival_s, r.kind, r.max_new,
                 np.asarray(r.payload).tolist()) for r in t.requests])


def test_from_trace_equals_jax():
    j = jfleet.from_trace(TRACE_FIXTURE, seed=0)
    t = tfleet.from_trace(TRACE_FIXTURE, seed=0)
    assert ([(r.arrival_s, r.entropy_hint, r.label, r.metadata)
             for r in j.requests]
            == [(r.arrival_s, r.entropy_hint, r.label, r.metadata)
                for r in t.requests])
    jrep, jpool = _sim(jfleet, j, jfleet.RoundRobinRouter())
    trep, tpool = _sim(tfleet, t, tfleet.RoundRobinRouter())
    assert report_json(trep, tpool) == report_json(jrep, jpool)


# ---------------------------------------------------------------------------
# the reference's claims (tests/test_fleet.py) on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_every_request_served_exactly_once(policy):
    sc = tfleet.flash_crowd(800, qps=50.0, seed=4)
    rep, _ = _run(sc, tfleet.make_router(policy))
    assert sorted(r.rid for r in rep.responses) == list(range(800))
    for r in rep.responses:
        assert r.t_finish >= r.arrival_s - 1e-12
    assert sum(rep.summary["routed"].values()) == 800


def test_heterogeneous_paths_actually_used():
    sc = tfleet.flash_crowd(900, qps=60.0, seed=5)
    rep, _ = _run(sc, tfleet.RoundRobinRouter())
    assert {r.path for r in rep.responses} == set(KINDS3)


def test_replica_drain_flushes_and_revive_serves_again():
    sc = tfleet.flash_crowd(300, qps=200.0, seed=6)
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=("dynamic-batch",))
    pool.start()
    rep = pool.replicas[0]
    for req in sc.requests[:40]:
        rep.push(req)
    assert rep.load().queue_depth > 0
    flushed = rep.drain(sc.requests[39].arrival_s)
    assert rep.state == tfleet.STOPPED
    assert rep.load().queue_depth == 0
    assert flushed and not rep.routable
    rep.revive()
    assert rep.state == tfleet.ACTIVE and rep.routable
    rep.push(sc.requests[40])
    out = rep.finish(sc.requests[40].arrival_s)
    assert sorted(r.rid for r in out) == list(range(41))


def test_pool_rejects_duplicate_names():
    sc = tfleet.flash_crowd(10, qps=50.0, seed=0)
    r1 = tfleet.make_sim_replica("a", "direct", sc.oracle)
    r2 = tfleet.make_sim_replica("a", "direct", sc.oracle)
    with pytest.raises(ValueError):
        tfleet.ReplicaPool([r1, r2])


@pytest.mark.parametrize("baseline", ["round-robin", "least-loaded"])
def test_energy_router_wins_on_energy(baseline):
    """The headline: the energy-aware router spends fewer joules per
    request than round-robin on a flash crowd at equal accuracy, and no
    more than least-loaded on a multi-tenant mix."""
    if baseline == "round-robin":
        sc, bound = tfleet.flash_crowd(1500, qps=40.0, seed=0), 0.95
    else:
        sc, bound = tfleet.multi_tenant(1500, qps=80.0, seed=1), 1.0
    ea, _ = _run(sc, tfleet.EnergyAwareRouter())
    other, _ = _run(sc, tfleet.make_router(baseline))
    if baseline == "round-robin":
        assert ea.summary["accuracy"] == pytest.approx(
            other.summary["accuracy"], abs=0.01)
        assert (ea.summary["joules_per_request"]
                < bound * other.summary["joules_per_request"])
    else:
        assert (ea.summary["joules_per_request"]
                <= other.summary["joules_per_request"])


def test_energy_router_sheds_load_to_batch_under_pressure():
    calm = tfleet.flash_crowd(800, qps=30.0, flash_x=1.0, seed=7)
    rep_calm, _ = _run(calm, tfleet.EnergyAwareRouter())
    assert (rep_calm.summary["routed"]["direct-0"]
            / rep_calm.summary["n"]) > 0.95
    crowd = tfleet.flash_crowd(2500, qps=40.0, flash_x=15.0, seed=7)
    rep_crowd, _ = _run(crowd, tfleet.EnergyAwareRouter())
    managed = (rep_crowd.summary["n"]
               - rep_crowd.summary["routed"]["direct-0"])
    assert managed > 0.2 * rep_crowd.summary["n"]


def test_static_router_pins_one_replica():
    sc = tfleet.flash_crowd(300, qps=40.0, seed=8)
    rep, _ = _run(sc, tfleet.StaticRouter())
    assert rep.summary["routed"]["direct-0"] == 300


def test_closed_loop_controllers_per_replica():
    def ctrl(kind, i):
        return TController(threshold=TThreshold(1.0, 0.45, 0.3))

    sc = tfleet.flash_crowd(1200, qps=80.0, seed=9)
    rep, pool = _run(sc, tfleet.RoundRobinRouter(), controller_factory=ctrl)
    assert sorted(r.rid for r in rep.responses) == list(range(1200))
    assert rep.summary["admission_rate"] < 1.0
    for r in pool:
        assert r.controller.n_seen > 0
        assert r.controller.meter.total_joules > 0


def test_autoscaler_drains_and_revives_with_hysteresis():
    sc = tfleet.diurnal(3000, qps=8.0, peak_x=45.0, period_s=30.0, seed=2)
    base, _ = _run(sc, tfleet.EnergyAwareRouter())
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    scaled = tfleet.FleetSimulator(
        pool, tfleet.EnergyAwareRouter(),
        autoscaler=tfleet.Autoscaler(cooldown_s=1.0)).run(sc.requests)
    acts = [a["action"] for a in scaled.autoscaler_log]
    assert acts.count("drain") >= 1
    assert acts.count("revive") >= 1
    assert sorted(r.rid for r in scaled.responses) == list(range(3000))
    assert (scaled.summary["joules_per_request"]
            < base.summary["joules_per_request"])
    for a in scaled.autoscaler_log:
        assert {"t", "action", "replica", "pressure_ewma_s",
                "jpr_ewma"} <= set(a)


def test_autoscaler_respects_min_active():
    sc = tfleet.flash_crowd(600, qps=5.0, flash_x=1.0, seed=3)
    pool = tfleet.build_sim_fleet(sc.oracle, kinds=KINDS3)
    rep = tfleet.FleetSimulator(
        pool, tfleet.EnergyAwareRouter(),
        autoscaler=tfleet.Autoscaler(cooldown_s=0.5, min_active=2)
    ).run(sc.requests)
    assert len(pool.routable()) >= 2
    assert sorted(r.rid for r in rep.responses) == list(range(600))


def test_carbon_accounting_in_fleet_report():
    sc = tfleet.flash_crowd(500, qps=40.0, seed=1)
    rep, _ = _run(sc, tfleet.EnergyAwareRouter())
    assert rep.carbon["energy_j"] > 0
    assert rep.carbon["co2_kg"] > 0
    assert rep.summary["energy_j"] == pytest.approx(
        rep.carbon["energy_j"], rel=1e-3)


def test_with_payloads_label_override_keeps_flip_pattern():
    sc = tfleet.make_scenario("low-confidence-flood", 60, seed=2)
    src = sc.oracle
    flip_before = np.asarray(src.proxy_pred != src.labels)
    assert flip_before.any()
    toks = np.zeros((60, 4), np.int32)
    labels = np.asarray([i % 2 for i in range(60)])
    live = tfleet.with_payloads(sc, toks, labels=labels)
    np.testing.assert_array_equal(
        np.asarray(live.oracle.proxy_pred != live.oracle.labels),
        flip_before)
    np.testing.assert_array_equal(live.oracle.full_pred, labels)
    np.testing.assert_array_equal(live.oracle.entropy, src.entropy)


# ---------------------------------------------------------------------------
# the live fleet against the reference's, walltimes pinned
# ---------------------------------------------------------------------------

class _Clock:
    """A stand-in for the ``time`` module: every ``perf_counter`` read
    advances 1 ms, so each measured call takes exactly 1 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


SMALL = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab=120,
             max_pos=16)


@pytest.fixture(scope="module")
def live_models():
    cfg = jdb.config(**SMALL)
    params = jdb.init(cfg, jax.random.PRNGKey(0))
    model = convert.distilbert_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, model


def _live_run(pkg, cfg, params, toks, monkeypatch, closed_loop, **kw):
    mods = ((jadapters, jengine) if pkg is jfleet
            else (tadapters, tengine))
    clock = _Clock()
    for m in mods:
        monkeypatch.setattr(m, "time", clock)
    sc = pkg.with_payloads(pkg.flash_crowd(40, qps=60.0, seed=0), toks)
    ctrl, th = ((JController, JThreshold) if pkg is jfleet
                else (TController, TThreshold))
    factory = ((lambda kind, i: ctrl(threshold=th(1.0, 0.45, 0.3)))
               if closed_loop else None)
    pool = pkg.build_live_fleet(cfg, params, max_batch=4, calibrate=False,
                                controller_factory=factory, **kw)
    rep = pkg.FleetSimulator(pool, pkg.RoundRobinRouter()).run(sc.requests)
    return rep, pool, sc


@pytest.mark.parametrize("closed_loop", [False, True])
def test_live_fleet_matches_jax(live_models, monkeypatch, closed_loop):
    """flash_crowd(40) through the three live classify replicas of both
    packages (open-loop controllers, and each replica's own closed-loop
    one), walltimes pinned: the same path, replica, admission and
    finish time for every request, predictions equal, entropy within
    1e-5.  On the CPU the entropy kernel's plain version runs.  The
    pool re-runs cleanly."""
    cfg, params, model = live_models
    toks = np.random.default_rng(0).integers(
        0, 120, size=(40, 12)).astype(np.int32)
    jrep, jpool, _ = _live_run(jfleet, cfg, params, toks, monkeypatch,
                               closed_loop)
    tent.launches = 0
    trep, tpool, tsc = _live_run(tfleet, cfg, model, toks, monkeypatch,
                                 closed_loop, energy_model=TEM,
                                 device="cpu")
    assert tent.launches == 0            # the CPU runs the plain version
    jreq = per_request(jrep, jpool)
    treq = per_request(trep, tpool)
    assert [(r, p, n, a) for r, p, n, _, a in treq] == [
        (r, p, n, a) for r, p, n, _, a in jreq]
    np.testing.assert_allclose([x[3] for x in treq], [x[3] for x in jreq],
                               rtol=0, atol=1e-9)
    assert set(KINDS3) <= {r.path for r in trep.responses}
    assert ([int(r.output) for r in trep.responses]
            == [int(r.output) for r in jrep.responses])

    def entropies(rep):
        out = {}
        for r in rep.responses:
            e = r.telemetry.get("entropy")
            if e is None and r.decision is not None:
                e = r.decision.L
            out[r.rid] = e
        return out

    je, te = entropies(jrep), entropies(trep)
    assert set(je) == set(te) == set(range(40))
    assert all((je[k] is None) == (te[k] is None) for k in je)
    got = [te[k] for k in sorted(te) if te[k] is not None]
    want = [je[k] for k in sorted(je) if je[k] is not None]
    assert len(got) == 40
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert trep.summary["energy_j"] == pytest.approx(
        jrep.summary["energy_j"], rel=1e-9)
    # each adapter kept its full-model calls' walltimes
    batch_times = [rep.server.engine.batch_times for rep in tpool]
    assert all(len(b) > 0 for b in batch_times)

    if closed_loop:
        assert not all(r.admitted for r in trep.responses)
        return
    # re-running the SAME pool leaks no queue or clock of the first run
    rep2 = tfleet.FleetSimulator(tpool, tfleet.RoundRobinRouter()).run(
        tsc.requests)
    assert sorted(r.rid for r in rep2.responses) == list(range(40))
    assert ([(r.rid, r.path, r.admitted) for r in rep2.responses]
            == [(r.rid, r.path, r.admitted) for r in trep.responses])


def test_live_fleet_defaults_to_the_card(live_models):
    cfg, _, model = live_models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tfleet.build_live_fleet(cfg, model, max_batch=4, calibrate=False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tfleet.make_live_replica("d-0", "direct", cfg, model)


def test_live_kind_refusals():
    with pytest.raises(ValueError):
        tfleet.build_live_fleet({}, None, kinds=("continuous-decode",))
    with pytest.raises(ValueError, match=r"did you mean 'dynamic-batch'\?"):
        tfleet.make_live_replica("r0", "dynamic-batsh", {}, None)
    with pytest.raises(ValueError, match=r"did you mean 'generate'\?"):
        tfleet.build_live_fleet({}, None, kinds=("generat",))
    with pytest.raises(ValueError, match="expected one of") as ei:
        tfleet.make_live_replica("r0", "zzzz", {}, None)
    assert "did you mean" not in str(ei.value)
    # the generate kind stays listed, as in the reference, and waits
    # for disaggregation; nothing serves it in its place
    assert "generate" in tfleet.LIVE_REPLICA_KINDS
    with pytest.raises(NotImplementedError, match="item 10"):
        tfleet.make_live_replica("g-0", "generate", {}, None,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tfleet.build_live_fleet({}, None, kinds=("generate",),
                                device="cpu")
