"""The port's disaggregated serving (``repro_torch.disagg`` and the
session's insert half) against the JAX package's, on the CPU.

The stablelm-3b smoke config with f32 params (the reference's
``init_lm``, carried across) and both packages' default bf16 caches.
Each test of ``tests/test_disagg.py`` runs on both packages and holds
the port to the reference's result on the same inputs: the split-phase
tokens (contiguous and paged, FIFO inserts, EOS out of prefill) equal
the reference's split-phase tokens and the port's own pooled ones;
``kv_bytes`` counts what the reference counts; the link's times and
faults are the reference's numbers.  The ``DisaggSimulator`` on
``prompt-burst``, clean and through a decode crash plus a link flap,
with both packages' walltimes pinned to one deterministic counter,
gives the reference's per-request worker choices, transfer spans,
tokens and summary, byte for byte.  The disagg adapter passes the
``EnginePort`` checklist of ``tests/test_engine_port.py``, and the
mixed classify + generate fleet routes strictly by kind.
"""
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import disagg as jdisagg  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.configs import get_config as jget_full  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.core import LatencyModel as JLatencyModel  # noqa: E402
from repro.disagg import engine as jdengine  # noqa: E402
from repro.disagg import fleet as jdfleet  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import InferRequest as JRequest  # noqa: E402
from repro.serving import Oracle as JOracle  # noqa: E402
from repro.serving import Server as JServer  # noqa: E402
from repro.serving import ServerConfig as JServerConfig  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.telemetry.trace import Tracer as JTracer  # noqa: E402
from repro_torch import disagg as tdisagg  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.configs import get_config as tget_full  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.core import LatencyModel as TLatencyModel  # noqa: E402
from repro_torch.disagg import engine as tdengine  # noqa: E402
from repro_torch.disagg import fleet as tdfleet  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import ALL_PATHS, EnginePort  # noqa: E402
from repro_torch.serving import InferRequest as TRequest  # noqa: E402
from repro_torch.serving import Oracle as TOracle  # noqa: E402
from repro_torch.serving import Server as TServer  # noqa: E402
from repro_torch.serving import ServerConfig as TServerConfig  # noqa: E402
from repro_torch.serving import TriageResult  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.telemetry.trace import Tracer as TTracer  # noqa: E402

ARCH = "stablelm-3b"
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)
LAYOUTS = {"contiguous": {}, "paged": {"kv_block_size": 8}}


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).replace(dtype="float32", remat=False)
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


def _side(pair, side, **cfg_kw):
    """(the package's disagg module, continuous module, cfg, params)."""
    jcfg, params, tcfg, model = pair
    if side == "jax":
        return jdisagg, jcont, jcfg.replace(**cfg_kw), params, {}
    return tdisagg, tcont, tcfg.replace(**cfg_kw), model, {"device": "cpu"}


def _workload(mod, vocab, n=6, plen=8, seed=0, eos=None):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, plen) for _ in range(n)]
    eos = eos or {}
    return [mod.GenRequest(rid=i, prompt=prompts[i], max_new=3 + (i % 3),
                           eos_id=eos.get(i)) for i in range(n)]


def _run_disagg(pair, side, *, n=6, n_slots=3, eos=None, **cfg_kw):
    """The three-step API by hand (the reference's ``_run_disagg``):
    prefill all, insert all, then advance the decode session dry."""
    dmod, cmod, cfg, params, dev = _side(pair, side, **cfg_kw)
    eng = dmod.DisaggEngine.build(cfg, params, n_slots=n_slots,
                                  max_seq=64, sync_every=4, **dev)
    reqs = _workload(cmod, cfg.vocab, n=n, eos=eos)
    session = eng.start_session()
    for r in reqs:
        eng.insert(eng.prefill(r, prompt_len=8), session)
    while not session.idle:
        eng.generate(session)
    return eng, session, reqs


def _run_pooled(pair, side, *, n=6, n_slots=3, eos=None, **cfg_kw):
    _, cmod, cfg, params, dev = _side(pair, side, **cfg_kw)
    reqs = _workload(cmod, cfg.vocab, n=n, eos=eos)
    cmod.ContinuousBatchingEngine(cfg, params, n_slots=n_slots, max_seq=64,
                                  sync_every=4, **dev).serve(reqs,
                                                             prompt_len=8)
    return reqs


def _tokens(reqs):
    return [r.generated for r in reqs]


# ---------------------------------------------------------------------------
# the parity oracle: split-phase == pooled == the reference, token for token
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_disagg_token_parity_matches_jax(pair, layout):
    """Prefill builds contiguous batch-1 rows either way; the paged
    insert scatters them into block-table pages.  The port's tokens are
    the reference's split-phase tokens, the port's pooled ones and the
    contiguous topology's; every block comes back."""
    kw = LAYOUTS[layout]
    jeng, jsess, jsplit = _run_disagg(pair, "jax", **kw)
    teng, tsess, tsplit = _run_disagg(pair, "torch", **kw)
    pooled = _run_pooled(pair, "torch", **kw)
    assert _tokens(tsplit) == _tokens(jsplit) == _tokens(pooled)
    assert _tokens(tsplit) == _tokens(_run_pooled(pair, "torch"))
    assert all(r.done for r in tsplit)
    assert tsess.insert_calls == jsess.insert_calls == len(tsplit)
    assert tsess.stats()["insert_calls"] == len(tsplit)
    for key in ("decode_steps", "occupied_slot_steps", "host_syncs",
                "prefill_calls", "insert_calls"):
        assert tsess.stats()[key] == jsess.stats()[key], key
    if layout == "paged":
        assert teng.decode.paged and teng.prefill_engine.paged
        assert len(tsess._free_blocks) == teng.decode.pool_blocks - 1
        for key in ("blocks_allocated", "blocks_freed",
                    "peak_blocks_in_use", "free_blocks", "pool_blocks"):
            assert tsess.stats()[key] == jsess.stats()[key], key


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_insert_queue_waits_for_free_slots(pair, layout):
    """More prefilled requests than slots: inserts queue on the host and
    seat as slots free — nothing dropped, FIFO — with the reference's
    tokens and the pooled ones."""
    kw = LAYOUTS[layout]
    _, _, jsplit = _run_disagg(pair, "jax", n=7, n_slots=2, **kw)
    _, tsess, tsplit = _run_disagg(pair, "torch", n=7, n_slots=2, **kw)
    assert _tokens(tsplit) == _tokens(jsplit)
    assert _tokens(tsplit) == _tokens(_run_pooled(pair, "torch", n=7,
                                                  n_slots=2, **kw))
    assert not tsess._insert_q and tsess.idle


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eos_at_prefill_completes_without_a_slot(pair, layout):
    """A request whose first token is its EOS completes on the host: it
    never takes a slot (nor, paged, a block), as in the reference."""
    kw = LAYOUTS[layout]
    out = {}
    for side in ("jax", "torch"):
        dmod, cmod, cfg, params, dev = _side(pair, side, **kw)
        eng = dmod.DisaggEngine.build(cfg, params, n_slots=2, max_seq=64,
                                      **dev)
        prompt = np.random.default_rng(3).integers(0, cfg.vocab, 8)
        pr = eng.prefill(cmod.GenRequest(rid=0, prompt=prompt, max_new=6),
                         prompt_len=8)
        r2 = cmod.GenRequest(rid=1, prompt=prompt, max_new=6,
                             eos_id=pr.first_token)
        session = eng.start_session()
        eng.insert(eng.prefill(r2, prompt_len=8), session)
        done = session.advance()
        assert [g.rid for g in done] == [1]
        assert r2.done and r2.generated == [pr.first_token]
        assert session.n_active == 0 and not session._active_host.any()
        assert session.idle and session.insert_calls == 0
        if eng.decode.paged:
            assert session.blocks_allocated == 0
        out[side] = pr.first_token
    assert out["torch"] == out["jax"]


def test_eos_mid_decode_matches_jax(pair):
    """An EOS reached mid-decode retires an inserted slot as the
    pooled window retires it: the reference's tokens, request by
    request."""
    probe = _run_pooled(pair, "torch")
    eos = {1: probe[1].generated[2]}
    _, _, jsplit = _run_disagg(pair, "jax", eos=eos)
    _, _, tsplit = _run_disagg(pair, "torch", eos=eos)
    assert _tokens(tsplit) == _tokens(jsplit)
    assert tsplit[1].generated[-1] == eos[1]


def test_paged_insert_refuses_an_unservable_request(pair):
    """A budget no pool state could hold raises the reference's error
    and takes no block."""
    _, _, cfg, model, _ = _side(pair, "torch", kv_block_size=8,
                                kv_pool_blocks=3)
    eng = tdisagg.DisaggEngine.build(cfg, model, n_slots=2, max_seq=64,
                                     device="cpu")
    r = tcont.GenRequest(rid=0, prompt=np.arange(8), max_new=30)
    session = eng.start_session()
    eng.insert(eng.prefill(r, prompt_len=8), session)
    with pytest.raises(ValueError, match="it can never be inserted"):
        session.advance()
    assert len(session._free_blocks) == 2 and session.blocks_allocated == 0


@pytest.mark.parametrize("prompt_tokens,prompt_len",
                         [(5, None), (8, None), (9, None), (200, None),
                          (5, 12)])
def test_prefill_engine_pads_like_the_pooled_refill(pair, prompt_tokens,
                                                    prompt_len):
    jcfg, _, tcfg, model = pair
    jpe = jdisagg.PrefillEngine(jcfg, {}, max_seq=64)
    tpe = tdisagg.PrefillEngine(tcfg, model, max_seq=64, device="cpu")
    want = {(5, None): 8, (8, None): 8, (9, None): 16, (200, None): 63,
            (5, 12): 12}[prompt_tokens, prompt_len]
    assert (tpe.pad_len(prompt_tokens, prompt_len)
            == jpe.pad_len(prompt_tokens, prompt_len) == want)


@pytest.mark.parametrize("arch,smoke", [
    ("stablelm-3b", True), ("stablelm-3b", False), ("mamba2-780m", True),
    ("minicpm3-4b", True), ("recurrentgemma-2b", True),
    ("granite-moe-3b-a800m", True), ("paligemma-3b", True),
    ("whisper-medium", True)])
def test_kv_bytes_counts_what_jax_counts(arch, smoke):
    """The logical prompt-KV payload: every leaf of a batch-1 cache of
    plen rows that has a shape, as the reference's ``eval_shape``
    counts it; stablelm-3b at published width in bf16 is 327,808 bytes
    a token and the 32 layers' int32 lengths."""
    jcfg = (jget if smoke else jget_full)(arch)
    tcfg = (tget if smoke else tget_full)(arch)
    jpe = jdengine.PrefillEngine(jcfg, {}, max_seq=64)
    for plen in (8, 16, 63):
        assert (tdengine.prompt_kv_bytes(tcfg, plen) == jpe.kv_bytes(plen))
    if arch == "stablelm-3b" and not smoke:
        assert tdengine.prompt_kv_bytes(tcfg, 8) == 8 * 327_808 + 32 * 4


def test_prefill_engine_kv_bytes_grows_and_caches(pair):
    _, _, tcfg, model = pair
    pe = tdisagg.PrefillEngine(tcfg, model, max_seq=64, device="cpu")
    assert 0 < pe.kv_bytes(8) < pe.kv_bytes(16)
    assert pe.kv_bytes(8) == pe.kv_bytes(8)
    assert set(pe._kv_bytes) == {8, 16}


def test_prefill_result_rows_and_sampled_first_token(pair):
    """A prefill's rows hold the prompt at ``plen`` rows (paged: its
    block multiple), and a sampled first token is the reference's: the
    request's key folded with ``plen``, never a slot's."""
    jcfg, params, tcfg, model = pair
    sp = dict(temperature=0.8, sample_top_k=16, sample_top_p=0.95,
              sampling_seed=11)
    for kw, rlen in (({}, 8), ({"kv_block_size": 16}, 16)):
        tpe = tdisagg.PrefillEngine(tcfg.replace(**sp, **kw), model,
                                    max_seq=64, device="cpu")
        jpe = jdisagg.PrefillEngine(jcfg.replace(**sp, **kw), params,
                                    max_seq=64)
        for rid in range(4):
            prompt = np.random.default_rng(rid).integers(0, tcfg.vocab, 6)
            tpr = tpe.prefill(tcont.GenRequest(rid=rid, prompt=prompt))
            jpr = jpe.prefill(jcont.GenRequest(rid=rid, prompt=prompt))
            assert tpr.first_token == jpr.first_token
            assert (tpr.plen, tpr.kv_bytes) == (jpr.plen, jpr.kv_bytes)
            assert tpr.rows.k.shape[2] == rlen
            assert (tpr.rows.pos[:, 0, :8].tolist()
                    == [list(range(8))] * tcfg.n_layers)


def test_insert_after_capture_reads_the_session_tensors(pair,
                                                        monkeypatch):
    """The insert writes the pool and the slot state IN PLACE, so a
    window replayed from an earlier capture reads the inserted rows.
    The CPU captures nothing: here every tensor's storage is held
    across inserts, windows and a second wave, which is what a replay
    needs (the card checks the replayed tokens, ``chip_smoke.py``
    ``disagg``)."""
    for kw in LAYOUTS.values():
        _, _, cfg, model, _ = _side(pair, "torch", **kw)
        eng = tdisagg.DisaggEngine.build(cfg, model, n_slots=2, max_seq=64,
                                         sync_every=4, device="cpu")
        session = eng.start_session()
        held = {n: t.data_ptr() for n, t in (
            *session._pool.leaves().items(),
            ("cur_tok", session._cur_tok), ("pos", session._pos),
            ("active", session._active), ("remaining", session._remaining),
            ("eos", session._eos), ("skey", session._skey),
            ("temp", session._temp))}
        reqs = _workload(tcont, cfg.vocab, n=5)
        for r in reqs[:2]:
            eng.insert(eng.prefill(r, prompt_len=8), session)
        session.advance()
        for r in reqs[2:]:
            eng.insert(eng.prefill(r, prompt_len=8), session)
        while not session.idle:
            session.advance()
        now = {n: t.data_ptr() for n, t in (
            *session._pool.leaves().items(),
            ("cur_tok", session._cur_tok), ("pos", session._pos),
            ("active", session._active), ("remaining", session._remaining),
            ("eos", session._eos), ("skey", session._skey),
            ("temp", session._temp))}
        assert now == held
        assert _tokens(reqs) == _tokens(_run_pooled(pair, "torch", n=5,
                                                    n_slots=2, **kw))


# ---------------------------------------------------------------------------
# the link
# ---------------------------------------------------------------------------

def test_transfer_queue_serialises_and_accounts(pair):
    tcfg = pair[2]
    nbytes = tdengine.prompt_kv_bytes(tcfg, 8)
    per = 0.01 + nbytes / 1e6
    runs = []
    for mod in (jdisagg, tdisagg):
        pr = SimpleNamespace(kv_bytes=nbytes)
        q = mod.TransferQueue(gbps=1e-3, base_latency_s=0.01)  # slow link
        t1 = q.send(pr, 0.0, dst="d0")
        t2 = q.send(pr, 0.0, dst="d1")
        assert t1.arrive_t == pytest.approx(per)
        assert t2.arrive_t == pytest.approx(2 * per)     # FIFO
        assert q.n_transfers == 2 and q.total_bytes == 2 * nbytes
        assert q.pressure(0.0) == pytest.approx(2 * per)
        assert q.pressure(t2.arrive_t + 1.0) == 0.0
        landed = [t.dst for t in q.deliver(t1.arrive_t)]
        assert landed == ["d0"] and len(q.inflight) == 1
        assert [t.dst for t in q.deliver_all()] == ["d1"]
        stats = q.stats()
        q.reset()
        assert q.n_transfers == 0 and not q.inflight
        runs.append((t1.arrive_t, t2.arrive_t, t2.start_t, stats))
    assert runs[1] == runs[0]


def test_transfer_flap_drops_inflight_and_stalls_link():
    runs = []
    for mod in (jdisagg, tdisagg):
        tq = mod.TransferQueue(gbps=1.0, base_latency_s=0.1)
        pr = SimpleNamespace(kv_bytes=1000)
        t1 = tq.send(pr, 0.0, dst="decode-0")
        t2 = tq.send(pr, 0.0, dst="decode-1")
        assert t2.arrive_t > t1.arrive_t          # serialised FIFO link
        lost = tq.flap(t1.arrive_t, duration_s=2.0)
        assert [t.dst for t in lost] == ["decode-1"]
        assert tq.n_dropped == 1
        assert tq.outage_until == pytest.approx(t1.arrive_t + 2.0)
        # nothing moves during the outage: the next send starts after it
        t3 = tq.send(pr, t1.arrive_t, dst="decode-0")
        assert t3.start_t >= tq.outage_until
        runs.append((t1.arrive_t, t2.arrive_t, tq.outage_until, t3.start_t,
                     t3.arrive_t, tq.stats()))
    assert runs[1] == runs[0]


def test_transfer_drop_to_and_collapse():
    runs = []
    for mod in (jdisagg, tdisagg):
        tq = mod.TransferQueue(gbps=1.0, base_latency_s=0.1)
        pr = SimpleNamespace(kv_bytes=1000)
        tq.send(pr, 0.0, dst="decode-0")
        tq.send(pr, 0.0, dst="decode-1")
        lost = tq.drop_to("decode-1")
        assert [t.dst for t in lost] == ["decode-1"]
        assert tq.deliver(10.0)                   # survivor still lands
        fast = tq.send(pr, 20.0, dst="decode-0")
        tq.collapse(30.0, duration_s=5.0, factor=4.0)
        slow = tq.send(pr, 30.0, dst="decode-0")
        assert ((slow.arrive_t - slow.start_t)
                > 2.0 * (fast.arrive_t - fast.start_t))
        runs.append((fast.arrive_t, slow.start_t, slow.arrive_t,
                     tq.stats()))
    assert runs[1] == runs[0]


def test_decode_worker_lookup_suggests_nearest():
    pool = tdisagg.DisaggPool(
        prefill_workers=[],
        decode_workers=[SimpleNamespace(name="decode-0"),
                        SimpleNamespace(name="decode-1")],
        transfer=tdisagg.TransferQueue())
    sim = tdisagg.DisaggSimulator(pool)
    assert sim._decode_worker("decode-1").name == "decode-1"
    with pytest.raises(KeyError, match="did you mean 'decode-0'"):
        sim._decode_worker("decode0")
    with pytest.raises(KeyError, match="did you mean 'decode-1'"):
        sim._worker("decode-l")


# ---------------------------------------------------------------------------
# the EnginePort adapter
# ---------------------------------------------------------------------------

def _adapter_requests(req_cls, vocab, n=5):
    rng = np.random.default_rng(1)
    return [req_cls(rid=i, arrival_s=0.01 * i,
                    payload=rng.integers(0, vocab, 8).astype(np.int32),
                    kind="generate", max_new=3) for i in range(n)]


def test_disagg_adapter_reports_transfer_extras(pair):
    """Through ``Server``: every request answered with the reference's
    tokens, and the link carried each one."""
    outs = {}
    for side, srv, cfg_cls, req_cls in (
            ("jax", JServer, JServerConfig, JRequest),
            ("torch", TServer, TServerConfig, TRequest)):
        dmod, _, cfg, params, dev = _side(pair, side)
        adapter = dmod.DisaggEngineAdapter(
            dmod.DisaggEngine.build(cfg, params, n_slots=2, max_seq=32,
                                    **dev), prompt_len=8)
        out = srv(adapter, cfg_cls(path="generate")).serve(
            _adapter_requests(req_cls, cfg.vocab))
        assert sorted(r.rid for r in out) == list(range(5))
        assert all(r.path == "generate" for r in out)
        assert all(len(r.output) == 3 for r in out)
        st = adapter.transfer.stats()
        assert st["n_transfers"] == 5 and st["total_bytes"] > 0
        outs[side] = ({r.rid: list(r.output) for r in out}, st)
    assert outs["torch"] == outs["jax"]


def test_disagg_adapter_engine_port_conformance(pair):
    """``tests/test_engine_port.py``'s checklist, its ``disagg`` case."""
    _, _, cfg, model, _ = _side(pair, "torch")
    engine = tdisagg.DisaggEngineAdapter(
        tdisagg.DisaggEngine.build(cfg, model, n_slots=2, max_seq=32,
                                   device="cpu"), prompt_len=8)
    requests = _adapter_requests(TRequest, cfg.vocab, n=8)
    assert isinstance(engine, EnginePort)
    caps = engine.capabilities()
    assert caps.name == "disagg" and caps.kind == "generate"
    assert caps.paths and set(caps.paths) <= set(ALL_PATHS)
    c2 = engine.capabilities()
    assert (c2.name, c2.paths) == (caps.name, caps.paths)
    server = TServer(engine, TServerConfig(path="generate"))
    server.start()
    ctx = server.ctx
    assert engine.pressure(0.0) == pytest.approx(0.0)
    assert engine.load().queue_depth == 0
    tri = engine.triage(requests[0], requests[0].arrival_s, ctx)
    assert isinstance(tri, TriageResult)
    assert tri.L is None or np.isfinite(float(tri.L))
    assert tri.cost_s >= 0.0
    l1, l2 = engine.load(), engine.load()
    assert (l1.queue_depth, l1.batch_fill) == (l2.queue_depth,
                                               l2.batch_fill)
    now = requests[-1].arrival_s
    p1, p2 = engine.pressure(now), engine.pressure(now)
    assert p1 == p2 >= 0.0
    for r in requests:
        server.push(r)
    out = server.finish()
    assert sorted(r.rid for r in out) == [r.rid for r in requests]
    for r in out:
        assert r.t_finish >= r.arrival_s - 1e-9
        assert r.path in ALL_PATHS + ("skip",)
    horizon = max(r.t_finish for r in out) + 100.0
    assert engine.pressure(horizon) == pytest.approx(0.0)


def test_disagg_adapter_traces_its_phases(pair, monkeypatch):
    """The adapter's spans, walltimes pinned on both sides (1 ms a clock
    read) and a slow link, so transfers queue: ``prefill`` on the
    prefill line, ``transfer.wait`` and ``transfer`` on the link and
    ``decode.window`` on the decode horizon, each at the reference's
    times."""
    from repro.disagg import adapter as jdadapter
    from repro_torch.disagg import adapter as tdadapter
    phases = ("prefill", "transfer.wait", "transfer", "decode.window")
    spans = {}
    for side, srv, cfg_cls, req_cls, tracer, mods in (
            ("jax", JServer, JServerConfig, JRequest, JTracer(),
             (jdadapter, jdengine)),
            ("torch", TServer, TServerConfig, TRequest, TTracer(),
             (tdadapter, tdengine))):
        clock = _Clock()
        for m in mods:
            monkeypatch.setattr(m, "time", clock)
        dmod, _, cfg, params, dev = _side(pair, side)
        adapter = dmod.DisaggEngineAdapter(
            dmod.DisaggEngine.build(cfg, params, n_slots=2, max_seq=32,
                                    **dev), prompt_len=8,
            transfer=dmod.TransferQueue(gbps=1e-4))
        srv(adapter, cfg_cls(path="generate"), tracer=tracer).serve(
            _adapter_requests(req_cls, cfg.vocab))
        spans[side] = [(s.name, s.t_start, s.t_end, s.resource)
                       for s in tracer.spans if s.name in phases]
    assert {name for name, *_ in spans["torch"]} == set(phases)
    assert spans["torch"] == spans["jax"]


# ---------------------------------------------------------------------------
# the phase-aware fleet
# ---------------------------------------------------------------------------

def test_phase_aware_router_penalises_resource_pressure():
    class Basin:
        def __init__(self, rp):
            self._rp = rp

        def pressure(self, now):
            return 0.1

        def resource_pressure(self, now):
            return self._rp

    class Plain:
        def pressure(self, now):
            return 0.1

    got = []
    for mod in (jdisagg, tdisagg):
        r = mod.PhaseAwareRouter(slo_s=0.25)
        free = r.congestion(Basin(0.0), 0.0, 0.25)
        full = r.congestion(Basin(1.0), 0.0, 0.25)
        assert full == pytest.approx(2 * free)
        # replicas without the hook (classifier kinds) pay no penalty
        assert r.congestion(Plain(), 0.0, 0.25) == pytest.approx(free)
        got.append((free, full))
    assert got[1] == got[0]


def test_generate_scenarios_build_generate_requests():
    for name in tfleet.GENERATE_SCENARIOS:
        sc = tfleet.make_generate_scenario(name, 20, seed=1, vocab=64)
        assert sc.n == 20
        ts = [r.arrival_s for r in sc.requests]
        assert ts == sorted(ts)
        assert all(r.kind == "generate" for r in sc.requests)
        assert all(r.payload is not None and len(r.payload) > 0
                   for r in sc.requests)
        assert all(getattr(r, "max_new", 0) >= 1 for r in sc.requests)
        sc2 = tfleet.make_generate_scenario(name, 20, seed=1, vocab=64)
        assert [r.arrival_s for r in sc2.requests] == ts


def _fleet(pair, side, n_slots=2, **cfg_kw):
    dmod, _, cfg, params, dev = _side(pair, side, **cfg_kw)
    em = {"energy_model": TEM} if side == "torch" else {}
    return dmod.build_disagg_fleet(cfg, params, n_prefill=2, n_decode=2,
                                   n_slots=n_slots, max_seq=64, **em, **dev)


def _scenario(pkg, vocab, n=12):
    return pkg.make_generate_scenario("prompt-burst", n, seed=0,
                                      vocab=vocab, short_prompt=8,
                                      long_prompt=16, max_new=3)


def test_disagg_simulator_serves_once_with_both_phases(pair):
    """The reference's claims on the port, and every request's tokens
    equal to the reference's (a worker choice changes no token)."""
    reps = {}
    for side, dmod, fmod in (("jax", jdisagg, jfleet),
                             ("torch", tdisagg, tfleet)):
        pool = _fleet(pair, side)
        sim = dmod.DisaggSimulator(
            pool, router=dmod.PhaseAwareRouter(),
            prefill_scaler=fmod.Autoscaler(min_window=4),
            decode_scaler=fmod.Autoscaler(min_window=4), scale_every=4)
        rep = sim.run(_scenario(fmod, pair[0].vocab).requests)
        reps[side] = rep
    rep = reps["torch"]
    assert sorted(r["rid"] for r in rep.responses) == list(range(12))
    assert all(len(r["tokens"]) >= 1 for r in rep.responses)
    pool_served = {k: sum(v["n_served"] for n, v in rep.per_worker.items()
                          if n.startswith(k)) for k in ("prefill",
                                                        "decode")}
    assert pool_served == {"prefill": 12, "decode": 12}
    assert rep.transfer["n_transfers"] == 12
    assert rep.summary["energy_j"] > 0
    assert rep.summary["prefill_energy_j"] > 0
    assert rep.summary["decode_energy_j"] > 0
    assert all(r["latency_s"] >= 0 for r in rep.responses)
    assert ({r["rid"]: r["tokens"] for r in rep.responses}
            == {r["rid"]: r["tokens"] for r in reps["jax"].responses})
    assert rep.transfer == reps["jax"].transfer


class _Clock:
    """A stand-in for the ``time`` module: every ``perf_counter`` read
    advances 1 ms, so each measured call takes a fixed time."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def _pinned_run(pair, side, monkeypatch, story, layout):
    """``prompt-burst`` (24 requests) through the disagg fleet of one
    package, its walltimes pinned; ``story`` adds the reference's decode
    crash plus link flap mid-run.  -> (report, the tracer's transfer
    spans per rid)."""
    dmod, fmod, faults, mods = (
        (jdisagg, jfleet, jfaults, (jdengine, jdfleet)) if side == "jax"
        else (tdisagg, tfleet, tfaults, (tdengine, tdfleet)))
    clock = _Clock()
    for m in mods:
        monkeypatch.setattr(m, "time", clock)
    sc = _scenario(fmod, pair[0].vocab, n=24)
    pool = _fleet(pair, side, **LAYOUTS[layout])
    kw = {}
    if story == "crash_and_flap":
        mid = sc.requests[len(sc.requests) // 2].arrival_s
        kw = dict(injector=faults.FaultInjector(faults.FaultPlan.scripted([
            faults.FaultEvent(t=mid, kind="crash", target="decode-0",
                              duration_s=0.2),
            faults.FaultEvent(t=mid, kind="link-flap", duration_s=0.05)])),
            retry_policy=faults.RetryPolicy())
    tracer = JTracer() if side == "jax" else TTracer()
    sim = dmod.DisaggSimulator(
        pool, router=dmod.PhaseAwareRouter(),
        prefill_scaler=fmod.Autoscaler(min_window=4),
        decode_scaler=fmod.Autoscaler(min_window=4), scale_every=4,
        tracer=tracer, **kw)
    rep = sim.run(sc.requests)
    transfers = sorted((s.attrs["rid"], s.t_start, s.t_end,
                        s.attrs["bytes"], s.attrs["dst"])
                       for s in tracer.spans if s.name == "transfer")
    return rep, transfers


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("story", ["clean", "crash_and_flap"])
def test_disagg_simulator_matches_jax_pinned_clock(pair, monkeypatch,
                                                   story, layout):
    """Walltimes pinned on both sides (1 ms a clock read): the same
    prefill and decode worker for every request, the same transfer
    spans (start, arrival, bytes, destination), tokens, summary, per-
    worker report, link stats and autoscaler log, byte for byte; the
    crash story resolves every rid exactly once."""
    jrep, jtr = _pinned_run(pair, "jax", monkeypatch, story, layout)
    trep, ttr = _pinned_run(pair, "torch", monkeypatch, story, layout)
    assert _dumps(trep.responses) == _dumps(jrep.responses)
    assert ttr == jtr
    assert _dumps(trep.summary) == _dumps(jrep.summary)
    assert _dumps(trep.per_worker) == _dumps(jrep.per_worker)
    assert trep.transfer == jrep.transfer
    assert _dumps(trep.autoscaler_log) == _dumps(jrep.autoscaler_log)
    rids = [r["rid"] for r in trep.responses]
    assert sorted(rids) == list(range(24)) and len(set(rids)) == 24
    if story == "crash_and_flap":
        assert trep.summary["n_failures"] == 2
        assert (trep.summary["n_retries"]
                + trep.summary["n_retransmits"]) > 0


def test_disagg_decode_crash_recovers_exactly_once(pair):
    """A decode worker dies mid-run: its in-flight generation state is
    re-prefilled, dropped hand-offs are retransmitted, and every rid
    still resolves exactly once (served or rejected-with-reason); the
    crashed worker's new session starts with an empty pool."""
    sc = _scenario(tfleet, pair[0].vocab, n=10)
    pool = _fleet(pair, "torch")
    mid = sc.requests[len(sc.requests) // 2].arrival_s
    plan = tfaults.FaultPlan.scripted([
        tfaults.FaultEvent(t=mid, kind="crash", target="decode-0",
                           duration_s=0.2),
        tfaults.FaultEvent(t=mid, kind="link-flap", duration_s=0.05),
    ])
    before = pool.decode_workers[0].session
    sim = tdisagg.DisaggSimulator(pool, router=tdisagg.PhaseAwareRouter(),
                                  injector=tfaults.FaultInjector(plan),
                                  retry_policy=tfaults.RetryPolicy())
    rep = sim.run(sc.requests)
    rids = [r["rid"] for r in rep.responses]
    assert sorted(rids) == list(range(10))           # none hang
    assert len(set(rids)) == len(rids)               # exactly once
    served = [r for r in rep.responses if "rejected" not in r]
    assert all(len(r["tokens"]) >= 1 for r in served)
    assert rep.summary["n_served"] + rep.summary["n_rejected"] == 10
    assert rep.summary["n_failures"] == 2    # crash + link-flap
    assert rep.summary["n_retries"] + rep.summary["n_retransmits"] > 0
    assert pool.decode_workers[0].session is not before
    assert all(w.session.idle for w in pool.decode_workers)


def test_decode_worker_keeps_captures_off_the_clock(pair, monkeypatch):
    """A window capture is set-up: a decode worker's session is warmed
    (``DecodeSession.warm``, its windows captured) when the worker is
    built and again when a crash replaces it, before any of its windows
    is timed, and the worker counts the captures apart.  The CPU
    captures nothing, so a stub that books one 5 ms capture per window
    kind stands in for the card's."""
    clock = _Clock()

    def warm(self):
        for _ in self.engine.decode_captures:
            self.captures += 1
            self.capture_s += 0.005
            clock.t += 0.005
        return self

    monkeypatch.setattr(tcont.DecodeSession, "warm", warm)
    pool = _fleet(pair, "torch")
    w = pool.decode_workers[0]
    assert (w.captures, w.capture_s) == (2, pytest.approx(0.01))
    monkeypatch.setattr(tdfleet, "time", clock)
    pe = pool.prefill_workers[0].engine
    w.insert(pe.prefill(tcont.GenRequest(rid=0, prompt=np.arange(8),
                                         max_new=30), prompt_len=8))
    done, start, finish = w.advance(0.0)
    assert not done and finish - start == pytest.approx(1e-3)
    assert w.busy_s == pytest.approx(1e-3)
    old = w.session
    assert w.crash(0.0) == [0]
    assert w.session is not old and w.session.captures == 2
    assert (w.captures, w.capture_s) == (4, pytest.approx(0.02))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_warm_window_over_idle_slots_changes_no_token(pair, layout):
    """What ``DecodeSession.warm`` runs on the card before it captures:
    a window of each kind over a session none of whose slots is active.
    Run here uncaptured, it leaves every later request's tokens as they
    are without it, and no block of a paged pool taken."""
    _, _, cfg, model, _ = _side(pair, "torch", **LAYOUTS[layout])
    eng = tdisagg.DisaggEngine.build(cfg, model, n_slots=2, max_seq=64,
                                     sync_every=4, device="cpu")
    toks = []
    for warm in (False, True):
        session = eng.start_session()
        if warm:
            for kind in eng.decode.decode_captures:
                session._run_window(kind)
        reqs = _workload(tcont, cfg.vocab, n=5)
        for r in reqs:
            eng.insert(eng.prefill(r, prompt_len=8), session)
        while not session.idle:
            session.advance()
        toks.append(_tokens(reqs))
        if eng.decode.paged:
            st = session.stats()
            assert st["blocks_allocated"] == st["blocks_freed"]
    assert toks[0] == toks[1]


def test_mixed_fleet_routes_strictly_by_kind(pair):
    """A pool holding classifier AND generate replicas never
    cross-routes, and the live generate replica (the disagg adapter)
    answers with the reference's tokens."""
    outs = {}
    for side, fmod, oracle_cls, lat, req_cls in (
            ("jax", jfleet, JOracle, JLatencyModel, JRequest),
            ("torch", tfleet, TOracle, TLatencyModel, TRequest)):
        _, _, cfg, params, dev = _side(pair, side)
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 2, 8)
        oracle = oracle_cls(full_pred=labels.copy(),
                            proxy_pred=labels.copy(),
                            entropy=rng.uniform(0, 0.6, 8), labels=labels,
                            proxy_latency=lat(0.0002, 0.0))
        em = {"energy_model": TEM} if side == "torch" else {}
        pool = fmod.ReplicaPool([
            fmod.make_sim_replica("cls-0", "direct", oracle, **em),
            fmod.make_live_replica("gen-0", "generate", cfg, params,
                                   n_slots=2, max_seq=32, prompt_len=8,
                                   **em, **dev),
        ])
        reqs = []
        for i in range(8):
            if i % 2 == 0:
                reqs.append(req_cls(rid=i, arrival_s=0.01 * i,
                                    label=int(labels[i])))
            else:
                reqs.append(req_cls(
                    rid=i, arrival_s=0.01 * i,
                    payload=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    kind="generate", max_new=3))
        assert [r.name for r in pool.routable_for(reqs[0])] == ["cls-0"]
        assert [r.name for r in pool.routable_for(reqs[1])] == ["gen-0"]
        rep = fmod.FleetSimulator(pool, fmod.RoundRobinRouter()).run(reqs)
        assert sorted(r.rid for r in rep.responses) == list(range(8))
        assert rep.summary["routed"] == {"cls-0": 4, "gen-0": 4}
        gen_out = [r for r in rep.responses if r.rid % 2 == 1]
        assert all(r.path == "generate" for r in gen_out)
        assert all(len(r.output) == 3 for r in gen_out)
        outs[side] = {r.rid: list(r.output) for r in gen_out}
    assert outs["torch"] == outs["jax"]


def test_live_generate_fleet_answers_as_the_disagg_engine(pair):
    """A live fleet of two ``generate`` replicas (``build_live_fleet``,
    each a ``DisaggEngineAdapter`` over its own ``DisaggEngine``) under
    the energy-aware router: every rid answered once on the generate
    path, each request's tokens those of a ``DisaggEngine``'s three-step
    API on the same inputs, and those the reference's."""
    _, _, cfg, model, _ = _side(pair, "torch")
    pool = tfleet.build_live_fleet(cfg, model, kinds=("generate",) * 2,
                                   energy_model=TEM, device="cpu")
    sc = _scenario(tfleet, cfg.vocab, n=12)
    rep = tfleet.FleetSimulator(pool).run(sc.requests)
    assert sorted(r.rid for r in rep.responses) == list(range(12))
    assert all(r.path == "generate" for r in rep.responses)
    assert sum(rep.summary["routed"].values()) == 12
    got = {r.rid: list(r.output) for r in rep.responses}
    for side in ("torch", "jax"):
        dmod, cmod, c, params, dev = _side(pair, side)
        eng = dmod.DisaggEngine.build(c, params, n_slots=4, max_seq=64,
                                      **dev)
        session = eng.start_session()
        reqs = [cmod.GenRequest(rid=r.rid, prompt=np.asarray(r.payload),
                                max_new=r.max_new) for r in sc.requests]
        for r in reqs:
            eng.insert(eng.prefill(r), session)
        while not session.idle:
            eng.generate(session)
        assert got == {r.rid: list(map(int, r.generated)) for r in reqs}


def test_launcher_fleet_disagg_on_cpu(tmp_path):
    """``--fleet-disagg --smoke`` on the CPU, contiguous and paged: every
    request served once, both phases busy, the link's bytes the prefill
    engine's count; the reference's flag checks."""
    from repro_torch.launch import serve as tserve
    for extra in ([], ["--kv-block-size", "8"]):
        args = tserve.parser().parse_args(
            ["--device", "cpu", "--fleet-disagg", "--smoke", "--scenario",
             "prompt-burst", "--requests", "12", "--runs", str(tmp_path),
             *extra])
        out, rep, pool = tserve.serve_disagg(args)
        assert out["n_served"] == 12 and out["n_rejected"] == 0
        assert sorted(r["rid"] for r in rep.responses) == list(range(12))
        assert out["transfer"]["n_transfers"] == 12
        pe = pool.prefill_workers[0].engine
        sc = tfleet.make_generate_scenario("prompt-burst", 12, qps=40.0,
                                           seed=0, vocab=pe.cfg.vocab)
        assert out["transfer"]["total_bytes"] == sum(
            pe.kv_bytes(pe.pad_len(len(r.payload))) for r in sc.requests)
        assert out["n_layers"] == 2 and out["device"] == "cpu"
        assert out["kv_block_size"] == (8 if extra else 0)
        assert set(out["captures"]) == {"decode-0", "decode-1"}
    for argv, msg in ((["--fleet-disagg", "--fleet"], "separate layers"),
                      (["--fleet-disagg", "--scenario", "steady"],
                       "prompt-burst or long-decode")):
        with pytest.raises(SystemExit, match=msg):
            tserve.main(["--device", "cpu", "--smoke", *argv])
