"""The seeded traffic generator: every seed offers the same lengths in the
same order, with prompt ids of its own."""
import numpy as np

from perfbench.lib import traffic

MIX = {"requests": 200,
       "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8, "min": 64, "max": 1024},
       "output": {"dist": "uniform", "min": 256, "max": 1000},
       "sample": 4, "sizes_seed": 29}


def _key(specs):
    return [(s.rid, s.prompt.tobytes(), s.max_new) for s in specs]


def test_same_seed_same_requests():
    a = traffic.build(MIX, 2 ** 31 + 11, 50304)
    b = traffic.build(MIX, 2 ** 31 + 11, 50304)
    assert _key(a) == _key(b)


def test_seeds_share_the_work_in_the_same_order():
    a = traffic.build(MIX, 5, 50304)
    b = traffic.build(MIX, 2 ** 33 + 6, 50304)
    assert len(a) == len(b) == 200
    assert [len(s.prompt) for s in a] == [len(s.prompt) for s in b]
    assert [s.max_new for s in a] == [s.max_new for s in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_lengths_inside_their_laws():
    specs = traffic.build(MIX, 9, 50304)
    assert all(64 <= len(s.prompt) <= 1024 and 256 <= s.max_new <= 1000 for s in specs)
    assert all(0 <= s.prompt.min() and s.prompt.max() < 50304 for s in specs)
    assert 200 < np.median([len(s.prompt) for s in specs]) < 320
    assert 500 < np.mean([s.max_new for s in specs]) < 760
