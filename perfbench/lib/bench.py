"""One run of one cell: build the engine from the seed, warm it, drive the
backlog through ``DecodeSession.push`` / ``advance`` as a serving loop
would, measure the window, then judge what the window served against the
plain reference.

The configuration file names the module that describes its model
(``describe.load``): its sizes, parameters, reference logits and counts;
nothing here knows a layout.

The program is touched only here: ``repro_torch``'s configuration class,
its LM (whose parameters become the benchmark's seeded weights), the
continuous-batching engine, and its counters (``DecodeSession``'s
``prefill_s``, ``prefill_calls``, ``device_s``, ``decode_steps``).
Everything the benchmark times it times itself, on the host's clock,
around whole ``advance`` calls, each of which ends in a host sync.
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.lib import describe, flops, profile, traffic
from perfbench.lib import weights as wts

TRACE_S = 5.0          # a traced run's window: profiled whole, at most this
SMALL = 128            # the engine's power-of-two prompt buckets end here
FIRST_WAVE_FILL = 16   # the first wave is seated at most this many a refill


def padded_len(lengths, max_seq: int) -> int:
    """The prompt length a refill wave is prefilled at: its longest
    prompt, rounded up to a power of two up to 128, never past
    ``max_seq - 1``; every shorter prompt of the wave is right-padded with
    token 0 to it, and the first token is read at its last position."""
    n = max(max(lengths), 1)
    if n <= SMALL:
        n = 1 << (n - 1).bit_length()
    return min(n, max_seq - 1)


def decode_rows(plen: int, a: int, b: int) -> int:
    """Valid K/V rows the decode steps of tokens ``a .. b-1`` read: token
    m (>= 1) is decoded at position ``plen + m - 1`` over ``plen + m``
    rows."""
    return (b - a) * plen + (a + b - 1) * (b - a) // 2


@dataclass
class Req:
    spec: traffic.Spec
    gen: object                  # the program's GenRequest
    t_last: float | None = None  # return of the advance of its last token
    t_done: float | None = None
    n_out: int = 0
    plen: int = 0
    new: tuple | None = None     # tokens delivered by the last advance

    @property
    def max_new(self) -> int:
        return self.spec.max_new


@dataclass
class Tally:
    """Work counted from what the engine delivered."""
    tokens: int = 0              # output tokens delivered
    decode_tokens: int = 0       # of which by decode steps
    kv_rows: int = 0             # valid K/V rows decode attention read
    prompt_tokens: int = 0       # real prompt tokens prefilled
    prompt_pairs: int = 0        # causal pairs at the real lengths
    decode_pairs: int = 0        # (query, key) pairs of decode steps
    waves: int = 0
    wave_rows: int = 0
    wave_padded_tokens: int = 0  # real rows x the wave's padded length
    advances: int = 0

    def add(self, o: "Tally") -> None:
        for k in self.__dataclass_fields__:
            setattr(self, k, getattr(self, k) + getattr(o, k))


@dataclass
class Loop:
    """The serving loop's state: the session and the requests it has
    pushed."""
    session: object
    max_seq: int
    profiling: bool = False
    inflight: list = field(default_factory=list)

    def push(self, r: Req) -> None:
        self.session.push(r.gen)
        self.inflight.append(r)

    def advance(self) -> tuple[float, Tally]:
        s = self.session
        label = ("advance+refill" if s.n_queued and
                 s.n_active < s.engine.n_slots else "advance")
        if self.profiling:
            with torch.profiler.record_function(profile.SPAN + label):
                s.advance()
        else:
            s.advance()
        t_b = time.perf_counter()
        tally = Tally(advances=1)
        seated, still = [], []
        for r in self.inflight:
            n = len(r.gen.generated)
            if n > r.n_out:
                if r.n_out == 0:
                    seated.append(r)
                r.t_last = t_b
                tally.tokens += n - r.n_out
                r.new = (r.n_out, n)
                r.n_out = n
            else:
                r.new = None
            if r.gen.done:
                r.t_done = t_b
            else:
                still.append(r)
        if seated:
            plen = padded_len([len(r.spec.prompt) for r in seated], self.max_seq)
            tally.waves, tally.wave_rows = 1, len(seated)
            for r in seated:
                r.plen = plen
                L = len(r.spec.prompt)
                tally.prompt_tokens += L
                tally.prompt_pairs += flops.causal_pairs(L)
                tally.wave_padded_tokens += plen
        for r in self.inflight:
            if r.new is None:
                continue
            a, b = max(r.new[0], 1), r.new[1]   # token 0 is the prefill's
            if b > a:
                rows = decode_rows(r.plen, a, b)
                tally.decode_tokens += b - a
                tally.kv_rows += rows
                tally.decode_pairs += rows
        self.inflight = still
        return t_b, tally


def counters(session) -> dict:
    return {k: getattr(session, k) for k in
            ("prefill_s", "prefill_calls", "device_s", "decode_steps")}


def run_cell(cell: dict, model_file: dict, mix: dict, limits: dict, *,
             seed: int, seconds: float, trace: bool, device, energy,
             t_start: float) -> dict:
    """One run; -> the record the metric readers read, with the readings
    of the correctness check."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                                GenRequest)
    from repro_torch.serving.sampling import SamplingParams

    device = torch.device(device)
    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    m = model_file["model"]
    serving = model_file["serving"]
    ref = describe.load(model_file)
    z = ref.dims(m)
    cfg = ModelConfig(**m)
    params = tfm.LM(cfg, device="meta")
    weights = wts.make(ref, m, seed, device)
    wts.install(params, weights)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = ContinuousBatchingEngine(
        cfg, params.eval(), n_slots=int(serving["slots"]),
        max_seq=int(serving["max_seq"]), sync_every=8, draft_depth=0,
        capture="auto", device=device)
    session = engine.start_session()
    session.warm()
    specs = traffic.build(mix, seed, z["V"])
    # one request through a refill before any traffic: the prefill's
    # kernels are built and loaded in set-up, as the window's are by warm()
    first = GenRequest(rid=-1, prompt=specs[0].prompt, max_new=2, eos_id=None)
    session.push(first)
    while not session.idle:
        session.advance()
    phases["engine_and_capture"] = time.perf_counter() - t
    t = time.perf_counter()
    reqs = [Req(sp, GenRequest(rid=sp.rid, prompt=sp.prompt, max_new=sp.max_new,
                               eos_id=None, sampling=SamplingParams()))
            for sp in specs]
    loop = Loop(session, engine.max_seq)

    # Warm-up traffic: the first wave seated at most FIRST_WAVE_FILL a
    # refill, then the whole backlog queued; the window opens once every
    # request of the first wave has finished, so every slot has turned
    # over at least once and the mix of lengths in the slots is steady.
    n_slots = engine.n_slots
    wave = reqs[:n_slots]
    pushed = 0
    while not all(r.gen.done for r in wave):
        stop = min(pushed + FIRST_WAVE_FILL, n_slots) if pushed < n_slots else len(reqs)
        for r in reqs[pushed:stop]:
            loop.push(r)
        pushed = max(pushed, stop)
        loop.advance()
    for r in reqs[pushed:]:
        loop.push(r)

    prof = None
    if trace:
        seconds = min(seconds, TRACE_S)
        # CUPTI's start takes seconds; it comes before the window opens
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        loop.profiling = True
        span = torch.profiler.record_function(profile.SPAN + profile.WINDOW)
        span.__enter__()
    t0 = time.perf_counter()
    phases["warmup_traffic"] = t0 - t
    e0, c0 = energy.read_j(), counters(session)
    win, win_log = Tally(), []
    t_end = t0 + seconds
    while True:
        if session.n_queued == 0:
            raise RuntimeError("the backlog ran dry inside the window: "
                               "raise the mix's 'requests'")
        t_b, tally = loop.advance()
        win.add(tally)
        win_log.append((t_b - t0, tally.tokens))
        if t_b >= t_end:
            break
    e1, c1 = energy.read_j(), counters(session)
    if trace:
        span.__exit__(None, None, None)
        prof.stop()
        loop.profiling = False
    window_s = t_b - t0
    finished = [r for r in reqs if r.t_done is not None and r.t_done >= t0]
    half = window_s / 2
    counted = {k: c1[k] - c0[k] for k in c0}
    rec: dict = {"config": z, "ref": ref, "cell": cell["name"], "phases": phases}
    rec.update(
        half_rates=[sum(n for t, n in win_log if (t <= half) == first) / half
                    for first in (True, False)],
        setup_s=t0 - t_start, window_s=window_s, joules=e1 - e0, work=win,
        counters=counted,
        memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0),
        kv_bytes=kv_bytes(ref, z, n_slots, engine.max_seq, win.kv_rows,
                          counted["decode_steps"]),
        trace=None)
    if trace:
        rec["trace"] = profile.reduce(prof.events(), window_s)
    rec["attempted"] = sum(1 for r in reqs if r.t_last is not None and r.t_last >= t0)
    length_errors = sum(1 for r in finished if r.n_out != r.max_new)
    rec["failed"] = length_errors

    # -- correctness: the program's state goes first, then the reference
    sample = choose_sample(finished, int(mix["sample"]), seed)
    served = rec["served"] = [(r.spec, r.plen, list(r.gen.generated))
                              for r in sample]
    del session, engine, params, weights, loop, reqs, wave, sample, finished, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, rec["tokens_compared"], rec["worst"] = judge(ref, m, seed, served, device)
    readings["length_errors"] = float(length_errors)
    rec["readings"] = readings
    rec["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in readings.items() if k in limits}
    rec["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                         for c in rec["checks"].values())
    return rec


def kv_bytes(ref, z: dict, slots: int, max_seq: int, kv_rows: int,
             steps: int) -> dict:
    """The cache the engine holds for its slots (every slot at ``max_seq``
    rows) and the part of it that holds live rows, on average over the
    window's decode steps, at ``ref.cache_row_bytes`` a row."""
    per_row = ref.cache_row_bytes(z)
    return {"pool": slots * max_seq * per_row,
            "live": kv_rows / steps * per_row if steps else 0.0}


def choose_sample(finished, n: int, seed: int) -> list:
    """``n`` finished requests drawn from the seed, the longest among
    them."""
    if not finished or n <= 0:
        return []
    longest = max(finished, key=lambda r: (r.plen + r.n_out, -r.spec.rid))
    rest = [r for r in finished if r is not longest]
    pick = traffic.rng_of(seed, 7).permutation(len(rest))[:n - 1]
    return [longest] + [rest[j] for j in sorted(pick)]


def sequence(spec, plen: int, gen: list, device):
    """The tokens one causal pass reads to score a served request: its
    prompt right-padded with 0 to the wave's length, then every served
    token but the last; and the positions whose logits chose them."""
    prompt = np.zeros(plen, np.int64)
    prompt[:min(len(spec.prompt), plen)] = spec.prompt[:plen]
    seq = np.concatenate([prompt, np.asarray(gen[:-1], np.int64)])
    at = torch.arange(plen - 1, plen - 1 + len(gen), device=device)
    return torch.as_tensor(seq, device=device), at


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far, in logits, each served greedy token lies below the
    reference's best: ``ref`` [n, V], ``tokens`` [n] -> [n]."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None])[:, 0]


@torch.no_grad()
def judge(ref, m: dict, seed: int, served, device, *, weight=None):
    """The reference module ``ref``'s logits over each sampled request's
    padded prompt and served tokens (``weight``, the reference's parameter
    reader, defaults to the seeded weights widened to float32).  -> (the
    readings, the number of tokens compared, where the widest gap fell)."""
    z = ref.dims(m)
    if weight is None:
        w = wts.make(ref, m, seed, device)
        weight = lambda name: w[name].float()
    all_gaps, tokens_compared, worst = [], 0, (0.0, None)
    for spec, plen, gen in served:
        seq, at = sequence(spec, plen, gen, device)
        g = gaps(ref.logits(z, weight, seq, at),
                 torch.as_tensor(gen, device=device))
        all_gaps.append(g)
        j = int(g.argmax())
        if float(g[j]) > worst[0]:
            worst = (float(g[j]), {"rid": spec.rid, "token": j, "of": len(gen),
                                   "plen": plen, "prompt": len(spec.prompt)})
        tokens_compared += len(gen)
    return summarize(all_gaps), tokens_compared, worst[1]


def summarize(all_gaps) -> dict:
    """The numbers compared: the widest gap of a served token and the mean
    gap over every token compared; infinite where nothing was compared."""
    if not all_gaps:
        return {"logit_gap": math.inf, "mean_logit_gap": math.inf}
    g = torch.cat(all_gaps)
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}
