"""The decode session's spans and host-clock counters, on the CPU.

``DecodeSession`` records each ``advance`` into its ``tracer`` as a tree
of host spans (``decode.advance`` over ``decode.insert``,
``decode.refill`` and its four parts, ``decode.window.issue``,
``decode.window.sync`` and ``decode.harvest``) and keeps, tracer or
not, the counters ``window_sync_s``, ``harvest_s`` and ``caller_s``
beside the older ones.  Held here: the tree on the contiguous and the
paged pool and for an insert, the same tokens with and without a
tracer, nothing recorded by ``NULL_TRACER``, counters that add up to no
more than the wall time, no caller time while the session is idle, and
a ``WallClock`` span laid on a ``torch.profiler`` timeline through
``WallClock.epoch_ns``.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.disagg.engine import DisaggEngine  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.continuous import (ContinuousBatchingEngine,  # noqa: E402
                                            GenRequest)
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.telemetry.trace import (NULL_TRACER, Tracer,  # noqa: E402
                                         WallClock, validate_trace)

SLOTS, MAX_SEQ, SYNC = 3, 48, 4
MAX_NEW = [6, 3, 9, 4, 7]
REFILL_PARTS = ["decode.refill.alloc", "decode.refill.prefill",
                "decode.refill.scatter", "decode.refill.first"]
COUNTERS = ("prefill_s", "window_issue_s", "window_sync_s", "harvest_s",
            "caller_s")


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("stablelm-3b").replace(dtype="float32")
    return cfg, tfm.init_lm(cfg, 0, device="cpu")


def _engine(lm, layout):
    cfg, model = lm
    if layout == "paged":
        cfg = cfg.replace(kv_block_size=4)
    return ContinuousBatchingEngine(cfg, model, n_slots=SLOTS,
                                    max_seq=MAX_SEQ, sync_every=SYNC,
                                    device="cpu")


def _requests(vocab, sampled=False):
    rng = np.random.default_rng(3)
    sp = (SamplingParams(temperature=0.9, top_k=20, top_p=0.95, seed=5)
          if sampled else None)
    return [GenRequest(rid=i, prompt=rng.integers(0, vocab, int(n))
                       .astype(np.int32), max_new=m, sampling=sp)
            for i, (n, m) in enumerate(zip(rng.integers(3, 9, len(MAX_NEW)),
                                           MAX_NEW))]


def _drain(session):
    while not session.idle:
        session.advance()


def _within(child, parent):
    return parent.t_start <= child.t_start <= child.t_end <= parent.t_end


def _assert_tree(tracer, first, refill_children):
    """One advance's spans: ``first`` the names directly under
    ``decode.advance``, in order, and the refill's children."""
    assert validate_trace(tracer.spans) == []
    root, = tracer.find("decode.advance")
    assert root.parent_id is None and root.closed
    kids = tracer.children_of(root)
    assert [s.name for s in kids] == first
    for s in kids:
        assert _within(s, root)
    for a, b in zip(kids, kids[1:]):
        assert a.t_end <= b.t_start
    if "decode.refill" in first:
        refill, = tracer.find("decode.refill")
        parts = tracer.children_of(refill)
        assert [s.name for s in parts] == refill_children
        for s in parts:
            assert _within(s, refill)
            assert tracer.children_of(s) == []
        return refill
    return None


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_refilling_advance_records_the_span_tree(lm, layout):
    eng = _engine(lm, layout)
    tr = Tracer()
    s = eng.start_session(tracer=tr)
    reqs = _requests(lm[0].vocab)
    for r in reqs:
        s.push(r)
    s.advance()
    refill = _assert_tree(tr, ["decode.refill", "decode.window.issue",
                               "decode.window.sync", "decode.harvest"],
                          REFILL_PARTS)
    a = refill.attrs
    assert a["rids"] == [0, 1, 2]
    assert a["plen"] == 8 and a["rows"] == eng.prefill_rows(SLOTS)
    assert a["prompt_tokens"] == sum(len(r.prompt) for r in reqs[:SLOTS])
    assert a["padded_tokens"] == a["rows"] * a["plen"]
    root, = tr.find("decode.advance")
    assert root.attrs == {"active": 0, "queued": len(reqs)}
    # later advances: a refill span only where a slot is free for the queue
    while not s.idle:
        refills = s.n_queued > 0 and s.n_active < SLOTS
        tr.reset()
        s.advance()
        _assert_tree(tr, ["decode.refill"] * refills + [
            "decode.window.issue", "decode.window.sync", "decode.harvest"],
            REFILL_PARTS)


def test_insert_records_its_span_only_when_it_seats(lm):
    cfg, model = lm
    de = DisaggEngine.build(cfg, model, n_slots=1, max_seq=MAX_SEQ,
                            sync_every=SYNC, device="cpu")
    s = de.start_session()
    s.tracer = tr = Tracer()
    r0, r1 = _requests(cfg.vocab)[:2]
    de.insert(de.prefill(r0), s)
    de.insert(de.prefill(r1), s)
    s.advance()                       # seats r0; r1 waits for the slot
    _assert_tree(tr, ["decode.insert", "decode.window.issue",
                      "decode.window.sync", "decode.harvest"], [])
    assert tr.find("decode.insert")[0].attrs == {"seated": 1}
    while r1.slot is None:            # r1 waits: a drain that seats nothing
        tr.reset()
        s.advance()
        assert len(tr.find("decode.insert")) == (r1.slot is not None)
    _drain(s)
    assert r0.done and r1.done


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_tokens_equal_with_and_without_a_tracer(lm, layout, sampled):
    served = []
    for tracer in (NULL_TRACER, Tracer()):
        s = _engine(lm, layout).start_session(tracer=tracer)
        reqs = _requests(lm[0].vocab, sampled)
        for r in reqs:
            s.push(r)
        _drain(s)
        served.append([list(r.generated) for r in reqs])
    assert served[0] == served[1]
    assert [len(g) for g in served[0]] == MAX_NEW


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_null_tracer_records_nothing_and_counters_fit_the_wall(lm, layout):
    s = _engine(lm, layout).start_session()
    assert s.tracer is NULL_TRACER
    for r in _requests(lm[0].vocab):
        s.push(r)
    t0 = time.perf_counter()
    _drain(s)
    wall = time.perf_counter() - t0
    st = s.stats()
    assert NULL_TRACER.spans == []
    for k in ("window_sync_s", "harvest_s", "caller_s"):
        assert st[k] > 0, k
    assert sum(st[k] for k in COUNTERS) <= wall
    assert st["window_issue_s"] + st["window_sync_s"] \
        <= st["device_s"] - st["prefill_s"] + 1e-9


def test_caller_time_counts_only_while_slots_are_active(lm):
    s = _engine(lm, "contiguous").start_session()
    reqs = _requests(lm[0].vocab)
    for r in reqs:
        s.push(r)
    s.advance()
    c = s.caller_s
    time.sleep(0.05)
    s.advance()                       # slots were active: the pause counts
    assert s.caller_s - c >= 0.05
    _drain(s)
    c = s.caller_s
    time.sleep(0.05)                  # idle: no traffic, no caller time
    s.push(GenRequest(rid=99, prompt=reqs[0].prompt, max_new=2))
    s.advance()
    assert s.caller_s == c
    _drain(s)


def test_wallclock_span_lands_on_the_profiler_timeline():
    """A span timed on a ``WallClock`` around a ``record_function``
    block, converted through ``epoch_ns`` and the profile's
    ``trace_start_ns``, lies within 1 ms of the block's event."""
    clock = WallClock()
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            x @ x
        time.sleep(0.005)
        a = clock.now()
        with torch.profiler.record_function("block"):
            x @ x
            time.sleep(0.01)
        b = clock.now()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    us = lambda t: (clock.epoch_ns + t * 1e9 - start_ns) / 1e3  # noqa: E731
    ev, = [e for e in prof.events() if e.name == "block"]
    assert abs(ev.time_range.start - us(a)) < 1e3
    assert abs(ev.time_range.end - us(b)) < 1e3
