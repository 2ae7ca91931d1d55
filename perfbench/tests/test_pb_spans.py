"""The session-span reduction (``lib/spans.py``) on a synthetic profile:
two advances, the first with a refill, the card's operations and idle
gaps placed by hand, so every idle microsecond has a known owner."""
from types import SimpleNamespace

import pytest

from perfbench.lib import profile, spans
from perfbench.lib.spans import CALLER, OUTSIDE, Stretch
from repro_torch.telemetry.trace import Span


def ev(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        is_user_annotation=annotation)


# (name, start us, end us, id, parent)
TREE = [
    ("decode.advance", 100, 4000, 1, None),
    ("decode.refill", 150, 1500, 2, 1),
    ("decode.refill.alloc", 200, 300, 3, 2),
    ("decode.refill.prefill", 300, 800, 4, 2),
    ("decode.refill.scatter", 800, 900, 5, 2),
    ("decode.refill.first", 900, 1400, 6, 2),
    ("decode.window.issue", 1500, 1600, 7, 1),
    ("decode.window.sync", 1600, 3800, 8, 1),
    ("decode.harvest", 3800, 3950, 9, 1),
    ("decode.advance", 4500, 8000, 10, None),
    ("decode.window.issue", 4600, 4700, 11, 10),
    ("decode.window.sync", 4700, 7900, 12, 10),
    ("decode.harvest", 7900, 7990, 13, 10),
]
WINDOW = (0.0, 10000.0)
# the card's operations: the prefill, the first tokens, two windows (a
# 20-us gap inside the first), each window's copy back at its end
OPS = [(350, 700), (950, 1000), (1650, 2000), (2020, 3790), (3790, 3795),
       (4750, 7800), (7800, 7805)]


def stretches():
    return [Stretch(*t) for t in TREE]


def events(extra=()):
    out = [ev(profile.SPAN + profile.WINDOW, *WINDOW)]
    out += [ev(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(OPS)]
    return out + list(extra)


def test_timeline_shifts_by_the_two_clock_zeros():
    s = Span("decode.advance", t_start=1.0, t_end=1.5, span_id=3)
    st, = spans.timeline([s, Span("open", t_start=2.0)],
                         epoch_ns=5_000_000_000, trace_start_ns=4_000_000_000)
    assert (st.name, st.start, st.end, st.span_id) == \
        ("decode.advance", 2e6, 2.5e6, 3)


def test_idle_in_a_refill_is_the_refills_and_between_advances_the_callers():
    r = spans.reduce(events(), stretches())
    idle = {k: round(v * 1e6, 6) for k, v in r["idle_s"].items()}
    # idle: 0-350, 700-950, 1000-1650, 3795-4750, 7805-10000
    assert idle == {
        OUTSIDE: 100 + 2000,               # before the first, after the last
        "decode.advance": 50 + 50 + 100 + 10,
        "decode.refill": 50 + 100,         # its own: 150-200, 1400-1500
        "decode.refill.alloc": 100,
        "decode.refill.prefill": 50 + 100,
        "decode.refill.scatter": 100,
        "decode.refill.first": 50 + 400,
        "decode.window.issue": 100 + 100,
        "decode.window.sync": 50 + 5 + 50 + 95,
        "decode.harvest": 150 + 90,
        CALLER: 500,
    }
    assert r["small_gaps_s"] == pytest.approx(20e-6)
    assert r["count"][CALLER] == 1 and r["host_s"][CALLER] == pytest.approx(500e-6)
    assert r["count"]["decode.window.issue"] == 2
    assert r["host_s"]["decode.window.issue"] == pytest.approx(200e-6)


def test_an_interval_across_spans_is_split_exactly():
    # only the idle stretch 3795-4750, from the first window's copy to
    # the second's first operation, across seven spans
    ops = [(0, 3795), (4750, 10000)]
    evs = [ev(profile.SPAN + profile.WINDOW, *WINDOW)] + [
        ev(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(ops)]
    r = spans.reduce(evs, stretches())
    assert {k: round(v * 1e6, 6) for k, v in r["idle_s"].items()} == {
        "decode.window.sync": 5 + 50, "decode.harvest": 150,
        "decode.advance": 50 + 100, CALLER: 500, "decode.window.issue": 100}
    r = spans.reduce(events(), stretches())
    total = sum(r["idle_s"].values()) * 1e6
    assert total == pytest.approx(WINDOW[1] - WINDOW[0] - 20
                                  - sum(e - s for s, e in OPS))


def test_user_annotations_on_the_device_are_no_work():
    copies = [ev("pb.advance+refill", 0, 9000, device=True, annotation=True),
              ev("pb.advance", 4000, 9000, device=True),
              ev("decode.refill", 150, 1500, device=True, annotation=True)]
    assert spans.reduce(events(copies), stretches()) == \
        spans.reduce(events(), stretches())


def test_idle_adds_up_to_the_profile_reduction():
    ws = (WINDOW[1] - WINDOW[0]) / 1e6
    copies = [ev("pb.advance", 100, 4000), ev("pb.advance", 100, 4000, device=True)]
    r = spans.reduce(events(copies), stretches())
    p = profile.reduce(events(copies), ws)
    assert r["busy_s"] == pytest.approx(p["busy_s"])
    idle = sum(r["idle_s"].values()) + r["small_gaps_s"]
    assert abs(idle - (ws - p["busy_s"])) <= 0.01 * ws


@pytest.mark.parametrize("second, passed, offsets", [
    ([(4750, 7800), (7800, 7805)], 2, [-95, -5]),    # as traced: inside
    ([(4750, 7800), (7800, 8300)], 2, [-5, 400]),    # under 0.5 ms after
    ([(4750, 7800), (7800, 8500)], 1, [-5, 600]),    # later: clocks apart
    ([(4610, 4650), (4650, 4660)], 1, [-3240, -5]),  # before the sync began
], ids=["inside", "just-after", "late", "early"])
def test_alignment_of_each_windows_last_operation(second, passed, offsets):
    ops = OPS[:5] + second
    evs = [ev(profile.SPAN + profile.WINDOW, *WINDOW)] + [
        ev(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(ops)]
    a = spans.reduce(evs, stretches())["alignment"]
    assert (a["windows"], a["passed"]) == (2, passed)
    assert a["offset_us"] == pytest.approx(offsets)
