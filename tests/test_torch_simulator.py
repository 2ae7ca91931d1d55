"""The closed loop on a classifier the port trained, on the CPU.

``tests/test_system.py``'s three claims (the Table III shape, the full
model ahead of the proxy, entropy picking the hard examples) on a
classifier trained by the port's ``train_classifier`` from its own
seeded init, through the port's ``ClassifierEngine`` and
``ClosedLoopSimulator``; and the port's simulator against the
reference's on one seeded oracle and one request stream: host code on
both sides, so every decision, record and summary field is equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import numpy as np  # noqa: E402

from repro.core import AdmissionController as JController  # noqa: E402
from repro.core import DecayingThreshold as JThreshold  # noqa: E402
from repro.core import EnergyMeter as JMeter  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.core import LatencyModel as JLatency  # noqa: E402
from repro.serving import ClosedLoopSimulator as JSimulator  # noqa: E402
from repro.serving import DirectPath as JDirect  # noqa: E402
from repro.serving import DynamicBatcher as JBatcher  # noqa: E402
from repro.serving import Oracle as JOracle  # noqa: E402
from repro.serving import closed_loop_arrivals as jarrivals  # noqa: E402
from repro_torch.core import (AdmissionController,  # noqa: E402
                              DecayingThreshold, EnergyMeter, EnergyModel,
                              LatencyModel)
from repro_torch.models import distilbert  # noqa: E402
from repro_torch.serving import (ClassifierEngine,  # noqa: E402
                                 ClosedLoopSimulator, DirectPath,
                                 DynamicBatcher, Oracle,
                                 closed_loop_arrivals)
from repro_torch.training import (ClassificationData,  # noqa: E402
                                  train_classifier)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads spin while they wait, and the test
    workers run at once: this file's torch work runs on one thread,
    which is as fast alone (the model is tiny) and starves no other
    worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """``tests/test_system.py``'s classifier, trained by the port."""
    cfg = distilbert.config(n_layers=3, d_model=64, n_heads=4, d_ff=128,
                            vocab=600, max_pos=48)
    model = distilbert.init(cfg, seed=0, device="cpu")
    data = ClassificationData(vocab=600, seq_len=32, seed=42)
    model, log = train_classifier(model, data.train_batches(32), steps=120,
                                  log_every=60, verbose=False, device="cpu")
    assert log[-1]["ce"] < log[0]["ce"]
    engine = ClassifierEngine(cfg, model, exit_layer=2, device="cpu")
    return engine, data


def _sim(oracle, enabled, path="auto", em=None):
    ctrl = AdmissionController(
        threshold=DecayingThreshold(tau0=1.0, tau_inf=0.45, k=3.0),
        enabled=enabled, meter=EnergyMeter(model=em or EnergyModel()))
    return ClosedLoopSimulator(
        oracle=oracle, controller=ctrl,
        direct=DirectPath(LatencyModel(0.002, 0.003)),
        batched=DynamicBatcher(LatencyModel(0.015, 0.001),
                               max_batch_size=16, queue_window_s=0.004),
        energy_model=em or EnergyModel(), path=path)


def _oracle(engine, toks, labels):
    proxy_pred, entropy, _, _ = engine.proxy_scores(toks)
    full_pred, _ = engine.classify(toks)
    return Oracle(full_pred=full_pred, proxy_pred=proxy_pred,
                  entropy=entropy, labels=labels,
                  proxy_latency=LatencyModel(0.0003, 0.0))


def test_closed_loop_ablation_shape(trained):
    """Open loop against the bio controller on one workload: admitted
    work cut, time and energy saved, the accuracy drop small."""
    engine, data = trained
    n = 800
    toks, labels, _ = data.sample(n)
    oracle = _oracle(engine, toks, labels)
    reqs = closed_loop_arrivals(n, think_s=0.002)
    m_open = _sim(oracle, False).run(reqs)
    m_bio = _sim(oracle, True).run(reqs)
    assert m_open.admission_rate == 1.0
    assert m_bio.admission_rate < 0.9
    assert m_bio.busy_s < m_open.busy_s
    assert m_bio.energy_j < m_open.energy_j
    assert m_open.accuracy - m_bio.accuracy < 0.10


def test_full_model_beats_proxy(trained):
    engine, data = trained
    toks, labels, _ = data.sample(600)
    proxy_pred, _, _, _ = engine.proxy_scores(toks)
    full_pred, _ = engine.classify(toks)
    assert np.mean(full_pred == labels) >= np.mean(proxy_pred == labels)


def test_entropy_selects_hard_examples(trained):
    engine, data = trained
    n = 600
    diff = np.concatenate([np.full(n // 2, 0.2), np.full(n // 2, 0.95)])
    toks, _, _ = data.sample(n, difficulty=diff)
    _, entropy, _, _ = engine.proxy_scores(toks)
    assert entropy[n // 2:].mean() > entropy[:n // 2].mean()


# the JAX constants, pinned on both sides so host arithmetic matches
JEM = JEnergyModel()
TEM = EnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                  link_bw=JEM.ici_bw, p_active=JEM.p_active,
                  p_idle=JEM.p_idle)


@pytest.mark.parametrize("path", ["auto", "direct", "batched"])
@pytest.mark.parametrize("enabled", [True, False])
def test_simulator_matches_jax(path, enabled):
    """One seeded oracle (a proxy right on ~85 % of requests, the full
    model on ~97 %, entropies spread over [0, 0.7]) and one request
    stream: the same record for every request and the same
    ``summary()``."""
    n = 300
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, n)
    fields = dict(
        full_pred=np.where(rng.random(n) < 0.97, labels, 1 - labels),
        proxy_pred=np.where(rng.random(n) < 0.85, labels, 1 - labels),
        entropy=rng.uniform(0.0, 0.7, n).astype(np.float32), labels=labels)
    oracle = Oracle(**fields, proxy_latency=LatencyModel(0.0003, 0.0))
    joracle = JOracle(**fields, proxy_latency=JLatency(0.0003, 0.0))
    reqs = closed_loop_arrivals(n, think_s=0.002, labels=labels)
    jreqs = jarrivals(n, think_s=0.002, labels=labels)
    assert [dataclasses.astuple(r) for r in reqs] == [
        dataclasses.astuple(r) for r in jreqs]
    got = _sim(oracle, enabled, path, TEM).run(reqs)
    jctrl = JController(
        threshold=JThreshold(tau0=1.0, tau_inf=0.45, k=3.0),
        enabled=enabled, meter=JMeter(model=JEM))
    want = JSimulator(
        oracle=joracle, controller=jctrl,
        direct=JDirect(JLatency(0.002, 0.003)),
        batched=JBatcher(JLatency(0.015, 0.001), max_batch_size=16,
                         queue_window_s=0.004),
        energy_model=JEM, path=path).run(jreqs)
    assert sorted(dataclasses.astuple(r) for r in got.records) == sorted(
        dataclasses.astuple(r) for r in want.records)
    assert got.summary() == want.summary()
    assert (got.busy_s, got.span_s, got.energy_j) == (
        want.busy_s, want.span_s, want.energy_j)
    if enabled and path == "auto":
        assert 0.0 < got.admission_rate < 1.0
