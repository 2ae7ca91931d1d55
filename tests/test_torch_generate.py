"""The port's continuous-batching generate path against the reference,
on the CPU.

The stablelm-3b smoke config with f32 params (the reference's
``init_lm``, carried across) on a seeded trace with more requests than
slots, so slots are reused across refill waves, mixed ``max_new`` and
one request that stops on its ``eos_id``.  Both engines run their
default cache, bf16 (the reference's ``DecodeSession`` always takes
``init_cache``'s default): logits then differ by up to ~1e-3 where a
projected key rounds to another bf16 value, and the greedy tokens of
this trace are equal for every request.  The window counters
(``decode_steps``, ``occupied_slot_steps``, ``host_syncs``) are equal
too.  Through ``Server`` + ``ContinuousEngineAdapter`` + the bio
controller, with one ``EnergyModel`` pinned on both sides and the
adapters' wall clock replaced by a fixed 2 ms per window (the
controller reads measured busy time), every admission and every output
is the same.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.core import AdmissionController as JController  # noqa: E402
from repro.core import DecayingThreshold as JThreshold  # noqa: E402
from repro.core import EnergyMeter as JMeter  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import adapters as jadapters  # noqa: E402
from repro.serving import api as japi  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyMeter as TMeter  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import adapters as tadapters  # noqa: E402
from repro_torch.serving import api as tapi  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import sampling as tsampling  # noqa: E402

ARCH = "stablelm-3b"
SLOTS, MAX_SEQ = 3, 48
MAX_NEW = [5, 9, 3, 12, 6, 2, 8]
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


def _prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 9, size=len(MAX_NEW))]


def _requests(mod, prompts, eos=None):
    eos = eos or {}
    return [mod.GenRequest(rid=i, prompt=p, max_new=m, eos_id=eos.get(i))
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


def _engines(pair, **kw):
    jcfg, params, tcfg, model = pair
    je = jcont.ContinuousBatchingEngine(jcfg, params, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, **kw)
    te = tcont.ContinuousBatchingEngine(tcfg, model, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("sync_every", [1, 4])
def test_engine_tokens_and_counters_match_jax(pair, sync_every):
    jcfg = pair[0]
    prompts = _prompts(jcfg.vocab)
    je, te = _engines(pair, sync_every=sync_every)
    # an EOS that request 1 reaches mid-stream, from a run without it
    probe = _requests(jcont, prompts)
    je.serve(probe)
    eos = {1: probe[1].generated[3]}
    jr, tr = _requests(jcont, prompts, eos), _requests(tcont, prompts, eos)
    js, ts = je.serve(jr), te.serve(tr)
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, b.rid
        assert b.done and b.admitted
    assert len(tr[1].generated) < MAX_NEW[1]          # stopped on its EOS
    assert [len(r.generated) for r in tr[2:]] == MAX_NEW[2:]
    for key in ("decode_steps", "occupied_slot_steps", "host_syncs",
                "prefill_calls", "tokens_generated", "n_admitted"):
        assert ts[key] == js[key], key
    if sync_every == 1:                              # one step per sync
        assert ts["host_syncs"] == ts["decode_steps"]
    assert ts["prefill_calls"] >= 2                    # slots were reused


def test_session_refill_respects_max_seq_and_eos_at_prefill(pair):
    """A budget past the pool's extent stops at ``max_seq - 1``; a
    request whose first (prefill) token is its EOS never takes a slot."""
    jcfg = pair[0]
    prompts = _prompts(jcfg.vocab, seed=9)[:3]
    je, te = _engines(pair, sync_every=3)
    first = _requests(jcont, prompts)
    for r in first:
        r.max_new = 1
    je.serve(first)
    eos = {0: first[0].generated[0]}
    out = {}
    for mod, eng in ((jcont, je), (tcont, te)):
        reqs = _requests(mod, prompts, eos)
        reqs[2].max_new = 200
        eng.serve(reqs)
        out[mod.__name__] = [r.generated for r in reqs]
    assert out[tcont.__name__] == out[jcont.__name__]
    assert len(out[tcont.__name__][0]) == 1
    assert len(out[tcont.__name__][2]) == MAX_SEQ - 8   # 8-token prompts


def test_slot_write_drops_padding_rows_and_rejects_repeats(pair):
    tcfg = pair[2]
    pool = ttfm.init_cache(tcfg, 3, 16, device="cpu")
    rows = ttfm.init_cache(tcfg, 3, 16, device="cpu")
    rows.k.fill_(1.0)
    rows.pos[:, :, :4] = torch.arange(4, dtype=torch.int32)
    tcont.slot_write(pool, rows, np.array([2, 3, 0]))   # row 1 is padding
    assert pool.k[:, 2].eq(1).all() and pool.k[:, 0].eq(1).all()
    assert pool.k[:, 1].eq(0).all()
    assert pool.pos[0, 2].tolist() == [0, 1, 2, 3] + [-1] * 12
    with pytest.raises(ValueError, match="repeated"):
        tcont.slot_write(pool, rows, np.array([1, 1, 0]))
    with pytest.raises(ValueError, match="does not fit"):
        tcont.slot_write(pool, ttfm.init_cache(tcfg, 3, 32, device="cpu"),
                         np.array([0, 1, 2]))


class _Clock:
    """A wall clock for the adapters: every window takes 2 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.001
        return self.t


def test_server_admissions_and_outputs_match_jax(pair, monkeypatch):
    jcfg, params, tcfg, model = pair
    monkeypatch.setattr(jadapters, "time", _Clock())
    monkeypatch.setattr(tadapters, "time", _Clock())
    n = 24
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab, size=(n, 8)).astype(np.int32)
    hints = rng.uniform(0, 1, size=n)

    def run(api, adapters, engine, ctrl, em):
        server = api.Server(adapters.ContinuousEngineAdapter(engine),
                            api.ServerConfig(path="continuous-decode",
                                             energy_model=em),
                            middleware=[api.AdmissionMiddleware(ctrl)])
        server.serve([api.InferRequest(
            rid=i, arrival_s=0.001 * i, payload=prompts[i], kind="generate",
            max_new=4 + i % 5, entropy_hint=float(hints[i]))
            for i in range(n)])
        return server

    je, te = _engines(pair, sync_every=4)
    js = run(japi, jadapters, je,
             JController(threshold=JThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=JMeter(model=JEM)), JEM)
    ts = run(tapi, tadapters, te,
             TController(threshold=TThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=TMeter(model=TEM)), TEM)

    def by_rid(server):
        return sorted((r.rid, r.path, r.admitted, r.output, r.t_finish)
                      for r in server.responses)

    assert by_rid(ts) == by_rid(js)
    tsum, jsum = ts.summary(), js.summary()
    assert np.isnan(tsum.pop("accuracy")) and np.isnan(jsum.pop("accuracy"))
    assert tsum == jsum                   # no labels in generation mode
    assert 0.0 < tsum["admission_rate"] < 1.0


def test_slot_clock_matches_jax():
    """The slot pool's virtual-time model: the same seats, starts,
    finishes, pressure and occupancy on a seeded stream of reservations
    and polls."""
    rng = np.random.default_rng(4)
    jc, tc = jcont.SlotClock(n_slots=3), tcont.SlotClock(n_slots=3)
    now = 0.0
    for dur in rng.uniform(0.01, 0.2, size=20):
        now += float(rng.exponential(0.03))
        assert tc.pressure(now) == jc.pressure(now)
        assert tc.busy(now) == jc.busy(now)
        assert tc.reserve(now, float(dur)) == jc.reserve(now, float(dur))
    assert tc.free_at == jc.free_at and tc.pressure(now) > 0.0
    tc.reset()
    assert tc.free_at == [0.0] * 3 and tc.busy(now) == 0


def test_sampling_and_speculation_serve_on_cpu(pair):
    """Both slices have landed: an engine with ``draft_depth=2`` over a
    one-layer draft serves the plain engine's tokens, and a sampled
    config and a sampled request are served (their parity with the
    reference is ``tests/test_torch_spec.py`` and
    ``tests/test_torch_decode_window.py``)."""
    tcfg, model = pair[2], pair[3]
    runs = []
    for cfg, depth in ((tcfg.replace(draft_layers=1), 2), (tcfg, 0)):
        reqs = [tcont.GenRequest(rid=i, prompt=np.arange(4, dtype=np.int32)
                                 + i, max_new=5) for i in range(3)]
        stats = tcont.ContinuousBatchingEngine(
            cfg, model, n_slots=2, max_seq=MAX_SEQ, draft_depth=depth,
            device="cpu").serve(reqs)
        runs.append(([r.generated for r in reqs], stats["mode"]))
    assert runs == [(runs[1][0], "spec"), (runs[1][0], "fused")]
    assert [len(g) for g in runs[0][0]] == [5, 5, 5]
    eng = tcont.ContinuousBatchingEngine(tcfg.replace(temperature=0.5), model,
                                         n_slots=2, max_seq=MAX_SEQ,
                                         device="cpu")
    assert eng.default_sampling.temperature == 0.5
    reqs = [tcont.GenRequest(rid=i, prompt=np.arange(4, dtype=np.int32),
                             max_new=3, sampling=sp)
            for i, sp in enumerate([None, tsampling.SamplingParams(
                temperature=0.7, top_k=4)])]
    eng.serve(reqs)
    assert [len(r.generated) for r in reqs] == [3, 3]


def test_launcher_generate_smoke_on_cpu(tmp_path):
    """``--mode generate --smoke`` end to end on the CPU: every request
    answered once, with 1 to new-tokens ids inside the vocabulary."""
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--smoke", "--requests",
         "6", "--new-tokens", "3", "--slots", "2", "--runs",
         str(tmp_path)])
    summary, server = tserve.serve_generate(args)
    vocab = tget(ARCH).vocab
    resp = sorted(server.responses, key=lambda r: r.rid)
    assert [r.rid for r in resp] == list(range(6))
    for r in resp:
        if r.admitted:
            assert 1 <= len(r.output) <= 3
            assert all(0 <= t < vocab for t in r.output)
    assert summary["arch"] == ARCH and summary["n_layers"] == 2
    assert summary["tokens_generated"] >= 1
    assert summary["decode_steps"] > 0
