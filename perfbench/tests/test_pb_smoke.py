"""A whole run on the CPU at smoke size (2 layers, d 128; the harness's
look for a card skipped): the port against the plain reference, the
control at the next precision below, and the timed path broken
underneath, each fault of a serving cell once, where ``correct`` has to
come out false.  (The exchange between chips is no fault these cells can
have: each runs on one card.)"""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench.lib import bench
from perfbench.reference import control

DATA = Path(__file__).resolve().parent / "data"
# smoke-size limits (float32 weights, bfloat16 cache): far above the
# port's readings here (0.005 at most over 15 runs) and
# far below a broken path's (0.15 and more)
LIMITS = {"logit_gap": 0.05, "length_errors": 0}


class Clock:
    """Stands in for the card's energy counter: 300 W of the host clock."""

    def read_j(self):
        return time.perf_counter() * 300.0


def _run(conf, seed, seconds=1.0, sample=None):
    torch.set_num_threads(2)
    mix = json.loads((DATA / "smoke-backlog.json").read_text())
    if sample:
        mix["sample"] = sample
    return bench.run_cell({"name": "smoke"}, json.loads((DATA / f"{conf}.json").read_text()),
                          mix, LIMITS, seed=seed, seconds=seconds, trace=False,
                          device="cpu", energy=Clock(), t_start=time.perf_counter())


@pytest.mark.parametrize("conf,seed", [
    ("smoke-dense", 2 ** 31 + 5),
    ("smoke-moe", 17),
    ("smoke-dense", 2 ** 33 + 1),
])
def test_port_agrees_with_the_reference(conf, seed):
    rec = _run(conf, seed)
    assert rec["correct"], rec["checks"]
    assert rec["tokens_compared"] >= 40 and rec["work"].tokens > 0
    assert rec["attempted"] > 4 and rec["failed"] == 0


def test_control_reads_above_the_program():
    """fp8 weights in the program's place: its gap is several times the
    port's at this size too."""
    rec = _run("smoke-dense", 99)
    ctl = control.control_readings(rec["ref"], json.loads(
        (DATA / "smoke-dense.json").read_text())["model"], 99, rec["served"], "cpu")
    prog = {k: c["value"] for k, c in rec["checks"].items()}
    assert ctl["logit_gap"] > 3 * max(prog["logit_gap"], 1e-3)


def _decode_leaves_cache(monkeypatch):
    """A decode step that returns its state unchanged: its K/V row is
    never written."""
    from repro_torch.models import attention
    orig = attention.cache_write

    def write(cache, k, v, pos):
        if k.shape[1] == 1 and not isinstance(pos, int):
            return cache
        return orig(cache, k, v, pos)
    monkeypatch.setattr(attention, "cache_write", write)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the slots gets no
    logits from the decode step."""
    from repro_torch.models import transformer
    orig = transformer.LM.decode_step

    def step(self, token, cache, pos):
        logits, cache = orig(self, token, cache, pos)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, cache
    monkeypatch.setattr(transformer.LM, "decode_step", step)


def _token_altered(monkeypatch):
    """A token altered where it is produced: the prefill's first token."""
    from repro_torch.serving import continuous
    orig = continuous.first_tokens

    def first(last, plen, rows, sampled):
        return (orig(last, plen, rows, sampled) + 1) % last.shape[-1]
    monkeypatch.setattr(continuous, "first_tokens", first)


def _norm_weights_dropped(monkeypatch):
    """Every norm at its identity: the seeded scales, offsets and biases
    left out."""
    from repro_torch.models import nn as pnn
    monkeypatch.setattr(pnn.LayerNorm, "forward", lambda self, x: pnn.layernorm(
        torch.ones_like(self.scale), torch.zeros_like(self.bias), x))
    monkeypatch.setattr(pnn.RMSNorm, "forward", lambda self, x: pnn.rmsnorm(
        torch.zeros_like(self.scale), x))


@pytest.mark.parametrize("fault", [_decode_leaves_cache, _half_batch, _token_altered,
                                   _norm_weights_dropped])
@pytest.mark.parametrize("conf", ["smoke-dense", "smoke-moe"])
def test_broken_path_is_not_correct(monkeypatch, fault, conf):
    fault(monkeypatch)
    # every finished request compared, so the half of the slots a fault
    # leaves out is always in the sample
    rec = _run(conf, 33, sample=1000)
    assert not rec["correct"], rec["checks"]
    assert rec["checks"]["logit_gap"]["value"] > LIMITS["logit_gap"]
