"""The work, rate and joules arithmetic: the loop's tally of what a fake
engine delivered, and the readers over a synthetic window that holds a
stall, which has to move the rate and the joules per token."""
import math
from types import SimpleNamespace

import numpy as np

from perfbench.lib import bench, describe, traffic
from perfbench.run import load_reader


class FakeSession:
    """Seats up to ``slots`` queued requests an advance, each seated one
    getting its first token, then gives every seated one ``per`` tokens."""

    def __init__(self, slots=2, per=4):
        self.engine = SimpleNamespace(n_slots=slots)
        self.queue, self.active, self.per = [], [], per

    @property
    def n_queued(self):
        return len(self.queue)

    @property
    def n_active(self):
        return len(self.active)

    def push(self, g):
        self.queue.append(g)

    def advance(self):
        for g in self.active:
            g.generated += [1] * min(self.per, g.max_new - len(g.generated))
        while self.queue and len(self.active) < self.engine.n_slots:
            g = self.queue.pop(0)
            g.generated.append(1)
            self.active.append(g)
        for g in self.active:
            g.done = len(g.generated) >= g.max_new
        self.active = [g for g in self.active if not g.done]


def _req(rid, plen, max_new):
    spec = traffic.Spec(rid=rid, prompt=np.zeros(plen, np.int32), max_new=max_new)
    return bench.Req(spec, SimpleNamespace(generated=[], done=False, max_new=max_new))


def test_tally_counts_what_was_delivered():
    loop = bench.Loop(FakeSession(slots=2, per=4), max_seq=2048)
    for r in (_req(0, 100, 9), _req(1, 20, 5), _req(2, 300, 3)):
        loop.push(r)
    total = bench.Tally()
    for _ in range(4):
        total.add(loop.advance()[1])
    assert total.tokens == 9 + 5 + 3 and total.waves == 2 and total.wave_rows == 3
    # the first wave is padded to its longest prompt's bucket, 128
    assert total.prompt_tokens == 420 and total.wave_padded_tokens == 128 + 128 + 300
    assert total.decode_tokens == 8 + 4 + 2
    assert total.kv_rows == (bench.decode_rows(128, 1, 9) + bench.decode_rows(128, 1, 5)
                             + bench.decode_rows(300, 1, 3))


def _window(stall_s):
    """1,000 tokens in 10 s at 300 W, and a stall of ``stall_s`` at 100 W
    in which nothing is delivered."""
    return {"work": bench.Tally(tokens=1000), "window_s": 10.0 + stall_s,
            "joules": 3000.0 + 100.0 * stall_s}


def test_rate_and_joules_move_with_a_stall():
    tps, jpt, pw = (load_reader(n) for n in
                    ("output_tokens_per_s", "joules_per_token", "avg_power_w"))
    calm, stalled = _window(0.0), _window(2.5)
    assert tps(calm) == 100.0 and jpt(calm) == 3.0 and pw(calm) == 300.0
    assert tps(stalled) == 80.0 and jpt(stalled) == 3.25
    assert math.isclose(pw(stalled), 3250.0 / 12.5)


def test_kv_bytes_pool_and_live():
    ref = describe.load({})
    z = {"L": 32, "K": 32, "hd": 80, "dtype": SimpleNamespace(itemsize=2)}
    kv = bench.kv_bytes(ref, z, 48, 2048, kv_rows=48 * 700 * 10, steps=10)
    assert kv["pool"] == 48 * 2048 * 327_680 and kv["live"] == 48 * 700 * 327_680


def test_padded_wave_length():
    assert bench.padded_len([3, 17, 9], 2048) == 32
    assert bench.padded_len([129, 40], 2048) == 129
    assert bench.padded_len([1, 1], 2048) == 1
    assert bench.padded_len([3000], 2048) == 2047
