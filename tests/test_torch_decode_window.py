"""The port's sampled decode window against the reference's, and its
own parity paths, on the CPU.

Engine against engine: the port's ``ContinuousBatchingEngine`` and the
reference's, on the same smoke-size weights (``convert.lm_from_numpy``)
and the same seeded trace (more requests than slots, mixed budgets, one
EOS), every request sampled at T 0.9 with top-k and top-p: the same
tokens for stablelm on the contiguous and the paged pool and for
mamba2.  Both sides run f32 caches (``init_cache``'s dtype patched on
both), so the only difference left between their logits is sum order,
far under the Gumbel-perturbed margins of this trace.

Inside the port: the fused window against the legacy per-step loop at
``sync_every`` 1 and 4, paged against contiguous, an explicit T = 0
against the default, slot reuse against solo runs, a request's own
``SamplingParams`` over the engine default, and the storage of every
session tensor across windows and refills (what a CUDA graph replay
needs).  The graph itself runs only on the card (``chip_smoke.py``
``decode_graph``); here ``capture=True`` raises, and the launch
counters' arithmetic is held on a stub graph.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import sampling as js  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import graphs  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402

SLOTS, MAX_SEQ = 3, 48
MAX_NEW = [5, 9, 3, 12, 6, 2, 8]
SP = dict(temperature=0.9, top_k=20, top_p=0.95, seed=7)


def _pair(arch):
    jcfg = jget(arch).replace(dtype="float32")
    tcfg = tget(arch).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def lm():
    return _pair("stablelm-3b")


@pytest.fixture(scope="module")
def ssm():
    return _pair("mamba2-780m")


def _prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 9, size=len(MAX_NEW))]


def _requests(mod, prompts, sp=None, eos=None):
    eos = eos or {}
    return [mod.GenRequest(rid=i, prompt=p, max_new=m, eos_id=eos.get(i),
                           sampling=sp)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


def _engine(pair, *, sync_every=4, **cfg_kw):
    return tcont.ContinuousBatchingEngine(
        pair[2].replace(**cfg_kw), pair[3], n_slots=SLOTS, max_seq=MAX_SEQ,
        sync_every=sync_every, device="cpu")


def _serve(engine, prompts, sp=None, *, legacy=False, eos=None):
    reqs = _requests(tcont, prompts, sp, eos)
    stats = engine.serve(reqs, legacy=legacy)
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("case", ["contiguous", "paged", "mamba2"])
def test_sampled_engine_matches_jax(lm, ssm, case, monkeypatch):
    pair = ssm if case == "mamba2" else lm
    jcfg, params, tcfg, model = pair
    paged = dict(kv_block_size=8) if case == "paged" else {}
    monkeypatch.setattr(jtfm, "init_cache", functools.partial(
        jtfm.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(ttfm, "init_cache", functools.partial(
        ttfm.init_cache, dtype=torch.float32))
    prompts = _prompts(jcfg.vocab)
    je = jcont.ContinuousBatchingEngine(jcfg.replace(**paged), params,
                                        n_slots=SLOTS, max_seq=MAX_SEQ,
                                        sync_every=4)
    probe = _requests(jcont, prompts, js.SamplingParams(**SP))
    je.serve(probe)
    eos = {1: probe[1].generated[2]}          # a sampled EOS mid-stream
    jr = _requests(jcont, prompts, js.SamplingParams(**SP), eos)
    jstats = je.serve(jr)
    got, tstats = _serve(_engine(pair, **paged), prompts,
                         ts.SamplingParams(**SP), eos=eos)
    assert got == [r.generated for r in jr]
    assert len(got[1]) == 3 and got[1][-1] == eos[1]
    for key in ("decode_steps", "occupied_slot_steps", "host_syncs",
                "prefill_calls", "tokens_generated"):
        assert tstats[key] == jstats[key], key
    assert tstats["window"] == "eager" and tstats["captures"] == 0


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-780m"])
def test_fused_matches_legacy_at_sync_1_and_4(lm, ssm, arch):
    pair = lm if arch == "stablelm-3b" else ssm
    prompts = _prompts(pair[0].vocab)
    sp = ts.SamplingParams(**SP)
    legacy, lstats = _serve(_engine(pair), prompts, sp, legacy=True)
    assert lstats["mode"] == "legacy"
    assert lstats["host_syncs"] == lstats["decode_steps"]
    for k in (1, 4):
        fused, _ = _serve(_engine(pair, sync_every=k), prompts, sp)
        assert fused == legacy, f"sync_every={k}"
    greedy, _ = _serve(_engine(pair), prompts)
    assert greedy != legacy


def test_paged_matches_contiguous_and_t0_matches_default(lm):
    prompts = _prompts(lm[0].vocab)
    sp = ts.SamplingParams(**SP)
    contiguous, _ = _serve(_engine(lm, sync_every=2), prompts, sp)
    paged, pstats = _serve(_engine(lm, sync_every=2, kv_block_size=8),
                           prompts, sp)
    assert paged == contiguous
    assert pstats["blocks_allocated"] == pstats["blocks_freed"]
    with pytest.raises(ValueError, match="legacy"):
        _engine(lm, kv_block_size=8).serve([], legacy=True)
    for layout in ({}, dict(kv_block_size=8)):
        default, _ = _serve(_engine(lm, sync_every=2, **layout), prompts)
        t0, _ = _serve(_engine(lm, sync_every=2, **layout), prompts,
                       ts.SamplingParams(temperature=0.0, top_k=5, seed=3))
        assert t0 == default, layout


def test_slot_reuse_does_not_replay_streams(lm):
    """Keys derive from request ids, not slots: two requests through one
    slot each make the stream they make alone, and the two differ."""
    sp = ts.SamplingParams(temperature=1.0, seed=3)
    prompt = np.random.default_rng(5).integers(0, lm[0].vocab, 8)

    def engine():
        return tcont.ContinuousBatchingEngine(lm[2], lm[3], n_slots=1,
                                              max_seq=MAX_SEQ, sync_every=2,
                                              device="cpu")

    def solo(rid):
        r = tcont.GenRequest(rid=rid, prompt=prompt, max_new=6, sampling=sp)
        engine().serve([r], prompt_len=8)
        return r.generated

    ref_a, ref_b = solo(101), solo(202)
    assert ref_a != ref_b
    ra = tcont.GenRequest(rid=101, prompt=prompt, max_new=6, sampling=sp)
    rb = tcont.GenRequest(rid=202, prompt=prompt, max_new=6, sampling=sp)
    engine().serve([ra, rb], prompt_len=8)         # rb waits for ra's slot
    assert (ra.generated, rb.generated) == (ref_a, ref_b)


def test_request_sampling_overrides_engine_default(lm):
    eng = tcont.ContinuousBatchingEngine(
        lm[2].replace(temperature=0.8, sampling_seed=5), lm[3], n_slots=2,
        max_seq=MAX_SEQ, sync_every=2, device="cpu")
    assert eng.default_sampling == ts.SamplingParams(temperature=0.8, seed=5)
    greedy_req = tcont.GenRequest(rid=0, prompt=np.arange(8), max_new=5,
                                  sampling=ts.SamplingParams())
    default_req = tcont.GenRequest(rid=1, prompt=np.arange(8), max_new=5)
    eng.serve([greedy_req, default_req], prompt_len=8)
    ref = tcont.GenRequest(rid=0, prompt=np.arange(8), max_new=5)
    tcont.ContinuousBatchingEngine(lm[2], lm[3], n_slots=2, max_seq=MAX_SEQ,
                                   sync_every=2, device="cpu").serve(
        [ref], prompt_len=8)
    assert greedy_req.generated == ref.generated
    assert default_req.generated != ref.generated


def _state(sess):
    pool = sess._pool
    tensors = [sess._cur_tok, sess._pos, sess._active, sess._remaining,
               sess._eos, sess._skey, sess._temp, sess._topk, sess._topp,
               sess._packed]
    tensors += [t for t in (pool.k, pool.v, pool.pos, pool.block_table,
                            pool.conv, pool.h) if t is not None]
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("case", ["contiguous", "paged", "mamba2"])
def test_session_state_keeps_its_storage(lm, ssm, case):
    """Every tensor a window reads or writes keeps its storage across
    windows, refills and slot reuse: a CUDA graph replays on the
    addresses it captured."""
    pair = ssm if case == "mamba2" else lm
    paged = dict(kv_block_size=8) if case == "paged" else {}
    sess = _engine(pair, sync_every=2, **paged).start_session()
    for r in _requests(tcont, _prompts(pair[0].vocab),
                       ts.SamplingParams(**SP)):
        sess.push(r)
    ptrs, windows = _state(sess), 0
    while not sess.idle:
        sess.advance()
        windows += 1
        assert _state(sess) == ptrs
    assert windows > 3 and sess.prefill_calls >= 2


def test_capture_true_on_cpu_raises(lm):
    with pytest.raises(ValueError, match="CUDA"):
        tcont.ContinuousBatchingEngine(lm[2], lm[3], device="cpu",
                                       capture=True)
    with pytest.raises(ValueError, match="capture"):
        tcont.ContinuousBatchingEngine(lm[2], lm[3], device="cpu",
                                       capture="always")
    eng = tcont.ContinuousBatchingEngine(lm[2], lm[3], device="cpu",
                                         capture=False)
    assert not eng.graphed and eng.decode_capture_count == 0


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_counted_graph_adds_its_launches_per_replay():
    """The capture's launches come off the counters (nothing ran) and
    each replay adds them once; a failed capture leaves the counters as
    they were and raises."""
    tda.launches, tda.paged_launches, tssd.launches = 5, 0, 1
    g = graphs.CountedGraph(_StubGraph())

    def body():
        tda.launches += 2
        tda.paged_launches += 3

    g.capture(body, context=torch.no_grad())
    assert (tda.launches, tda.paged_launches, tssd.launches) == (5, 0, 1)
    assert g.launches == {"decode_attention.launches": 2,
                          "decode_attention.paged_launches": 3}
    for _ in range(4):
        g.replay()
    assert (tda.launches, tda.paged_launches, tssd.launches) == (13, 12, 1)
    assert g.graph.replays == 4

    def broken():
        tssd.launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.CountedGraph(_StubGraph()).capture(broken,
                                                  context=torch.no_grad())
    assert tssd.launches == 1
    assert set(graphs.launch_counts()) == {
        "decode_attention.launches", "decode_attention.paged_launches",
        "decode_attention.chunk_launches",
        "decode_attention.combine_launches", "decode_attention.gqa_launches",
        "entropy.launches",
        "flash_attention.launches", "ssd_scan.launches",
        "latent_decode.launches", "latent_decode.merge_launches"}
    tda.launches = tda.paged_launches = tssd.launches = 0


def test_launcher_sampled_generate_on_cpu(tmp_path):
    """``--temperature 0.8 --top-k 50`` end to end on the CPU: every
    request answered, other tokens than greedy; ``--temperature 0`` is
    the default run, token for token (the open controller admits every
    request, so no decision rides on measured time)."""
    def run(*flags):
        args = tserve.parser().parse_args(
            ["--device", "cpu", "--mode", "generate", "--smoke",
             "--requests", "6", "--new-tokens", "4", "--slots", "2",
             "--controller", "open", "--runs", str(tmp_path), *flags])
        summary, server = tserve.serve_generate(args)
        return summary, {r.rid: r.output for r in server.responses}

    greedy_s, greedy = run()
    t0_s, t0 = run("--temperature", "0")
    sampled_s, sampled = run("--temperature", "0.8", "--top-k", "50",
                             "--top-p", "0.95")
    assert t0 == greedy and sorted(sampled) == list(range(6))
    assert sampled != greedy
    vocab = tget("stablelm-3b").vocab
    assert all(0 <= t < vocab for out in sampled.values()
               if isinstance(out, list) for t in out)
    assert sampled_s["window"] == "eager" and sampled_s["captures"] == 0


def test_adapter_passes_sampling_and_marks_captures(lm, monkeypatch):
    """Through ``Server`` + ``ContinuousEngineAdapter`` with a tracer: a
    request's ``sampling`` reaches the session (sampled tokens, other
    than greedy), every window is a ``decode.window`` span, and a window
    that captured a graph carries one ``cuda.graph_capture`` event (a
    capture is stood in for on the CPU by bumping the engine's count in
    the first window)."""
    from repro_torch.serving import adapters as tadapters
    from repro_torch.serving import api as tapi
    from repro_torch.telemetry.trace import Tracer

    run_window = tcont.DecodeSession._run_window

    def first_window_captures(self, kind):
        run_window(self, kind)
        if self.host_syncs == 0:
            self.engine.decode_captures[kind] += 1

    monkeypatch.setattr(tcont.DecodeSession, "_run_window",
                        first_window_captures)
    prompts = _prompts(lm[0].vocab)

    def serve(sp):
        tracer = Tracer()
        server = tapi.Server(
            tadapters.ContinuousEngineAdapter(_engine(lm)),
            tapi.ServerConfig(path="continuous-decode"), tracer=tracer)
        server.serve([tapi.InferRequest(
            rid=i, arrival_s=0.001 * i, payload=p, kind="generate",
            max_new=MAX_NEW[i], sampling=sp) for i, p in enumerate(prompts)])
        return {r.rid: r.output for r in server.responses}, tracer

    sampled, tracer = serve(ts.SamplingParams(**SP))
    greedy, _ = serve(None)
    assert sorted(sampled) == list(range(len(prompts))) and sampled != greedy
    assert [len(sampled[i]) for i in range(len(prompts))] == MAX_NEW
    events = tracer.find("cuda.graph_capture")
    assert len(events) == 1 and events[0].attrs["count"] == 1
    assert len(tracer.find("decode.window")) >= 3
