"""The port's classify serving path against the JAX reference, on the CPU.

Same weights (the reference's, carried across), same numpy tokens,
same arrival streams: the engine, the gated step and the whole
``Server`` are run on both sides and compared.  Entropies agree to
1e-4 (other sum orders); predictions and admissions exactly, except a
row whose J lies within 1e-5 of tau, where either side may round
across the threshold.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import AdmissionController as JController  # noqa: E402
from repro.core import DecayingThreshold as JThreshold  # noqa: E402
from repro.core import EnergyMeter as JMeter  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.core import LatencyModel as JLatency  # noqa: E402
from repro.models import distilbert as jdb  # noqa: E402
from repro.serving import adapters as jadapters  # noqa: E402
from repro.serving import api as japi  # noqa: E402
from repro.serving import batcher as jbatcher  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import gated as jgated  # noqa: E402
from repro.serving.simulator import Oracle as JOracle  # noqa: E402
from repro.serving.workload import poisson_arrivals as jarrivals  # noqa: E402
from repro.training import ClassificationData as JData  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyMeter as TMeter  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.core import LatencyModel as TLatency  # noqa: E402
from repro_torch.kernels import entropy as tent  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import adapters as tadapters  # noqa: E402
from repro_torch.serving import api as tapi  # noqa: E402
from repro_torch.serving import batcher as tbatcher  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import gated as tgated  # noqa: E402
from repro_torch.serving.simulator import Oracle as TOracle  # noqa: E402
from repro_torch.serving.workload import (  # noqa: E402
    poisson_arrivals as tarrivals)
from repro_torch.training.data import ClassificationData as TData  # noqa: E402

TOL = 1e-4
TIE = 1e-5
EXIT = 1
SMALL = dict(n_layers=3, d_model=64, n_heads=4, d_ff=128, vocab=600,
             max_pos=48)


@pytest.fixture(scope="module")
def pair():
    cfg = jdb.config(**SMALL)
    params = jdb.init(cfg, jax.random.PRNGKey(0))
    model = convert.distilbert_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, model


def _data(n, seed=11):
    toks, labels, diff = TData(vocab=600, seq_len=32, seed=seed).sample(n)
    jt, jl, jd = JData(vocab=600, seq_len=32, seed=seed).sample(n)
    # the port's copy of the data pipeline draws the same requests
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(diff, jd)
    return toks, labels


def test_core_gate_matches_jax():
    """The controller's tensor code: tau(t), the normalised J over a
    batch and the gate mask, fed the same observations on both sides."""
    from repro.core import CostModel as JCost
    from repro.core import gate_batch as jgate
    from repro_torch.core import CostModel as TCost
    from repro_torch.core import gate_batch as tgate
    rng = np.random.default_rng(4)
    jc, tc = JCost(), TCost()
    for L, E, C in rng.uniform(0, 2, (20, 3)):
        jc.observe(L, E, C)
        tc.observe(L, E, C)
    L = rng.uniform(0, 2, 64).astype(np.float32)
    E, C = 0.7, 1.3
    jJ = np.asarray(jc.J_batch(jnp.asarray(L), E, C))
    tJ = tc.J_batch(torch.from_numpy(L), E, C).numpy()
    np.testing.assert_allclose(tJ, jJ, rtol=1e-6, atol=1e-6)
    tau = float(np.median(tJ))
    sure = np.abs(tJ - tau) >= TIE
    for rule in ("le", "ge"):
        tm = tgate(torch.from_numpy(L), tau, E=E, C=C, cost=tc,
                   rule=rule).numpy()
        jm = np.asarray(jgate(jnp.asarray(L), tau, E=E, C=C, cost=jc,
                              rule=rule))
        np.testing.assert_array_equal(tm[sure], jm[sure])
    t = np.linspace(0.0, 10.0, 11)
    jth, tth = JThreshold(1.0, 0.45, 0.8), TThreshold(1.0, 0.45, 0.8)
    np.testing.assert_allclose(tth(t), np.asarray(jth(jnp.asarray(t))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tth(torch.from_numpy(t)).numpy(), tth(t), rtol=1e-12)
    assert tth(2.0) == pytest.approx(float(jth(2.0)), rel=1e-6)


def test_engine_matches_jax(pair):
    cfg, params, model = pair
    toks, _ = _data(37)                       # pads to the 64 bucket
    jeng = jengine.ClassifierEngine(cfg, params, exit_layer=EXIT,
                                    use_pallas_entropy=True)
    teng = tengine.ClassifierEngine(cfg, model, exit_layer=EXIT,
                                    device="cpu")
    jp, je, jm, _ = jeng.proxy_scores(toks)
    tp, te, tm, _ = teng.proxy_scores(toks)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(te, je, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm, jm, rtol=TOL, atol=TOL)
    assert te.dtype == np.float32 and tp.dtype == np.int32
    np.testing.assert_array_equal(teng.classify(toks)[0],
                                  jeng.classify(toks)[0])
    assert tengine.bucket_size(37) == jengine.bucket_size(37) == 64
    assert tengine.bucket_size(500) == 128


def _gate_inputs(model, B=16, n_valid=14):
    """A batch whose two lowest-J valid rows are identical, so their J
    ties exactly: the lower index must win the last bucket slot."""
    toks, _ = _data(B, seed=5)
    with torch.inference_mode():
        lg = model.early_exit_logits(torch.from_numpy(toks).long(),
                                     exit_layer=EXIT)
    ent = tent.entropy_stats_plain(lg)[0].numpy()
    lo = int(np.argmin(ent[:n_valid]))
    dup = 12 if lo < 12 else 2
    toks[dup] = toks[lo]
    return toks, min(lo, dup), max(lo, dup)


@pytest.mark.parametrize("capacity", [None, 1])
def test_gated_step_matches_jax(pair, capacity):
    cfg, params, model = pair
    B, n_valid, e_norm, c_norm = 16, 14, 0.3, 0.1
    toks, first, second = _gate_inputs(model, B, n_valid)
    tstep = tgated.make_gated_classify_step(cfg, exit_layer=EXIT,
                                            capacity=capacity, device="cpu")
    jstep = jgated.make_gated_classify_step(cfg, exit_layer=EXIT,
                                            capacity=capacity)
    # J from the port's own entropies; tau at the median valid J
    _, _, ent = tstep(model, toks, math.inf, e_norm, c_norm, n_valid)
    L = ent.numpy().astype(np.float64) / math.log(2)
    J = jgated.gate_objective(L, e_norm, c_norm)
    assert J[first] == J[second]              # an exact tie
    tau = float(np.median(J[:n_valid]))

    tp, ta, te = (x.numpy() for x in tstep(model, toks, tau, e_norm,
                                           c_norm, n_valid))
    jp, ja, je = (np.asarray(x) for x in jstep(params, jnp.asarray(toks),
                                               tau, e_norm, c_norm,
                                               n_valid))
    np.testing.assert_allclose(te, je, rtol=TOL, atol=TOL)
    sure = np.abs(J - tau) >= TIE
    np.testing.assert_array_equal(ta[sure], ja[sure])
    np.testing.assert_array_equal(tp[sure], jp[sure])
    assert not ta[n_valid:].any()             # pad rows never admitted
    cap = capacity or B // 2
    assert ta.sum() <= cap
    assert 0 < ta.sum()
    if capacity == 1:                         # the tie: lower index wins
        assert ta[first] and not ta[second]
        assert ja[first] and not ja[second]


def test_gated_step_sources(pair):
    """Admitted rows carry full-model predictions, skipped rows the
    proxy's."""
    cfg, _, model = pair
    toks, _ = _data(32)
    step = tgated.make_gated_classify_step(cfg, exit_layer=EXIT,
                                           capacity=32, device="cpu")
    pred, adm, _ = step(model, toks, 0.9, 0.0, 0.0)
    x = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = model.logits(x).argmax(-1)
        proxy = model.early_exit_logits(x, exit_layer=EXIT).argmax(-1)
    assert torch.equal(pred[adm], full[adm].int())
    assert torch.equal(pred[~adm], proxy[~adm].int())


# the JAX constants, pinned on both sides so host arithmetic matches
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)


def _bio(controller_cls, threshold_cls, meter_cls, em):
    return controller_cls(threshold=threshold_cls(tau0=1.0, tau_inf=0.45,
                                                  k=0.8),
                          meter=meter_cls(model=em))


def _by_rid(responses):
    return sorted(((r.rid, r.path, r.admitted, int(r.output), r.t_finish)
                   for r in responses))


def test_server_auto_path_matches_jax(pair):
    """The launcher's ``--path auto`` run: an Oracle from the engine's
    outputs, replayed through Server + OracleEngine + the bio
    controller.  Host code on both sides, so every decision and every
    virtual time is identical."""
    cfg, _, model = pair
    n = 160
    toks, labels = _data(n)
    teng = tengine.ClassifierEngine(cfg, model, exit_layer=EXIT,
                                    device="cpu")
    proxy_pred, entropy, _, _ = teng.proxy_scores(toks)
    full_pred, _ = teng.classify(toks)
    direct, batched = (0.002, 0.004), (0.012, 0.004)

    def run(api, adapters, batcher, oracle_cls, latency, ctrl, arrivals,
            em):
        oracle = oracle_cls(full_pred=full_pred, proxy_pred=proxy_pred,
                            entropy=entropy, labels=labels,
                            proxy_latency=latency(2e-4, 0.0))
        port = adapters.OracleEngine(
            oracle, batcher.DirectPath(latency(*direct)),
            batcher.DynamicBatcher(latency(*batched), max_batch_size=32,
                                   queue_window_s=0.01))
        server = api.Server(port, api.ServerConfig(path="auto",
                                                   energy_model=em),
                            middleware=[api.AdmissionMiddleware(ctrl)])
        server.serve(arrivals(n, 150.0, seed=0, labels=labels))
        return server

    js = run(japi, jadapters, jbatcher, JOracle, JLatency,
             _bio(JController, JThreshold, JMeter, JEM), jarrivals, JEM)
    ts = run(tapi, tadapters, tbatcher, TOracle, TLatency,
             _bio(TController, TThreshold, TMeter, TEM), tarrivals, TEM)
    assert _by_rid(ts.responses) == _by_rid(js.responses)
    assert ts.summary() == js.summary()
    assert 0.0 < ts.summary()["admission_rate"] < 1.0


def test_server_gated_open_loop_matches_jax(pair):
    """The launcher's ``--path gated`` run with the gate held open
    (capacity = batch): every request takes the full model on both
    sides, so every answer is the same."""
    cfg, params, model = pair
    n, batch = 40, 16
    toks, labels = _data(n)

    def run(api, adapters, gated_port, ctrl, arrivals, em):
        server = api.Server(gated_port, api.ServerConfig(path="gated",
                                                         energy_model=em),
                            middleware=[api.AdmissionMiddleware(ctrl)])
        server.serve(arrivals(n, 150.0, seed=0, payloads=toks,
                              labels=labels))
        return server

    js = run(japi, jadapters,
             jadapters.GatedEngineAdapter(cfg, params, batch=batch,
                                          capacity=batch, exit_layer=EXIT),
             JController(enabled=False, meter=JMeter(model=JEM)), jarrivals,
             JEM)
    ts = run(tapi, tadapters,
             tadapters.GatedEngineAdapter(cfg, model, batch=batch,
                                          capacity=batch, exit_layer=EXIT,
                                          device="cpu"),
             TController(enabled=False, meter=TMeter(model=TEM)), tarrivals,
             TEM)
    jr = {r.rid: r for r in js.responses}
    assert sorted(jr) == sorted(r.rid for r in ts.responses) == list(
        range(n))
    for r in ts.responses:
        ref = jr[r.rid]
        assert (r.path, r.admitted, r.output) == (ref.path, ref.admitted,
                                                  ref.output)
        assert abs(r.telemetry["entropy"] - ref.telemetry["entropy"]) <= TOL
    assert all(r.admitted for r in ts.responses)


def test_serve_gated_closed_loop(pair):
    cfg, _, model = pair
    toks, _ = _data(96)
    th = TThreshold(tau0=0.9, tau_inf=0.25, k=0.02)
    meter = TMeter(model=TEM)
    preds, admits, ents = tgated.serve_gated(cfg, model, toks,
                                             tau_schedule=th, exit_layer=EXIT,
                                             batch=32, meter=meter,
                                             device="cpu")
    assert preds.shape == admits.shape == ents.shape == (96,)
    assert 0.0 < admits.mean() < 1.0
    assert np.isfinite(ents).all() and meter.total_joules > 0


@pytest.mark.parametrize("path", ["auto", "gated"])
def test_launcher_serves_full_width_on_cpu(path, tmp_path):
    """The launcher end to end at full width (one layer, short
    sequences) on the plain-PyTorch path: every request answered, the
    summary finite, and no kernel launched on the CPU."""
    before = tent.launches
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--path", path, "--full-width", "--layers", "1",
         "--seq-len", "16", "--requests", "24", "--max-batch", "8",
         "--runs", str(tmp_path)])
    summary, server = tserve.serve_classifier(args)
    assert sorted(r.rid for r in server.responses) == list(range(24))
    assert all(r.output in (0, 1) for r in server.responses)
    assert summary["n"] == 24 and summary["d_model"] == 768
    assert summary["device"] == "cpu"
    assert all(math.isfinite(v) for v in summary.values()
               if isinstance(v, float))
    assert tent.launches == before


@pytest.fixture
def one_torch_thread():
    """Torch's intra-op threads spin while they wait, and the test
    workers train at once: train on one thread (as fast alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", ["auto", "gated"])
def test_launcher_serves_trained_default_on_cpu(path, tmp_path, monkeypatch,
                                                one_torch_thread):
    """The launcher's default: the reference's 3-layer, d 64 classifier
    trained first (here 5 steps, not 150), then served; ``--layers`` and
    ``--seq-len`` size only the full-width model."""
    build = tserve.build_classifier
    monkeypatch.setattr(tserve, "build_classifier",
                        lambda **kw: build(steps=5, **kw))
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--path", path, "--requests", "24",
         "--max-batch", "8", "--runs", str(tmp_path)])
    summary, server = tserve.serve_classifier(args)
    assert sorted(r.rid for r in server.responses) == list(range(24))
    assert all(r.output in (0, 1) for r in server.responses)
    assert (summary["n_layers"], summary["d_model"]) == (3, 64)
    assert all(math.isfinite(v) for v in summary.values()
               if isinstance(v, float))
    with pytest.raises(ValueError, match="--full-width"):
        tserve.serve_classifier(tserve.parser().parse_args(
            ["--device", "cpu", "--layers", "1"]))
