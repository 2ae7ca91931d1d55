"""``EnginePort`` adapter for the split-phase engine behind the unified
``Server``, ported from ``repro.disagg.adapter``.

Virtual-time accounting (the adapter contract): prefill is measured
walltime reserved on a prefill ``ServiceLine``; the finished rows
enter the :class:`TransferQueue` at the prefill's finish time and
land on the decode side after the link's latency; decode windows fold
measured walltime into a decode free-at horizon like
``ContinuousEngineAdapter`` (the session comes from
``DisaggEngine.start_session`` with its windows already captured, so
no capture reaches the horizon).
``pressure(now)`` is the SUM of the three phase backlogs — prefill
line, transfer link, decode horizon — so a router sees the whole
pipeline, not just the last stage."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.disagg.engine import DisaggEngine
from repro_torch.disagg.transfer import TransferQueue
from repro_torch.serving.api import (PATH_GENERATE, Completion,
                                     EngineCapabilities, LoadState,
                                     TriageResult, load_pressure)
from repro_torch.serving.batcher import ServiceLine
from repro_torch.serving.continuous import GenRequest


@dataclass
class DisaggEngineAdapter:
    """Prefill -> transfer -> insert -> generate behind ``EnginePort``.

    ``submit`` prefills the prompt immediately (measured), books the
    span on the prefill line, and sends the rows down the transfer
    link.  ``step`` (each arrival) delivers landed transfers into the
    decode session and advances one fused window, so decode
    interleaves with the arrival stream; ``drain`` fast-forwards past
    the last in-flight transfer and runs the session dry."""
    engine: DisaggEngine
    prompt_len: int | None = None
    transfer: TransferQueue = field(default_factory=TransferQueue)
    advance_on_arrival: bool = True

    _session: object = field(default=None, init=False)
    _by_rid: dict = field(default_factory=dict, init=False)
    _prefill_line: ServiceLine = field(default_factory=ServiceLine,
                                       init=False)
    _free_at: float = field(default=0.0, init=False)
    _pending_dt: float = field(default=0.0, init=False)

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="disagg", kind="generate",
                                  paths=(PATH_GENERATE,))

    def warmup(self, ctx) -> None:
        # fresh session and lines; the kernels stay built
        self._session = None
        self._by_rid.clear()
        self._prefill_line.reset()
        self.transfer.reset()
        self._free_at = 0.0
        self._pending_dt = 0.0

    def _ensure_session(self):
        if self._session is None:
            self._session = self.engine.start_session()
        return self._session

    def load(self) -> LoadState:
        depth = len(self.transfer.inflight)
        fill = 0.0
        if self._session is not None:
            depth += (self._session.n_queued
                      + len(self._session._insert_q))
            fill = (self._session.n_active
                    / max(self.engine.decode.n_slots, 1))
        return LoadState(queue_depth=depth, batch_fill=fill)

    def pressure(self, now: float) -> float:
        return (self._prefill_line.backlog(now)
                + self.transfer.pressure(now)
                + max(self._free_at - now, 0.0)
                + load_pressure(self.load()))

    def triage(self, req, now, ctx) -> TriageResult:
        hint = getattr(req, "entropy_hint", None)
        return TriageResult(L=0.5 if hint is None else float(hint),
                            proxy_output=[])

    def submit(self, req, path, now, ctx) -> list[Completion]:
        hint = getattr(req, "entropy_hint", None)
        meta = getattr(req, "metadata", None) or {}
        gr = GenRequest(rid=req.rid,
                        prompt=np.asarray(req.payload, np.int32),
                        max_new=getattr(req, "max_new", 16),
                        entropy_hint=(0.5 if hint is None
                                      else float(hint)),
                        arrival_t=float(req.arrival_s),
                        eos_id=meta.get("eos_id"))
        self._by_rid[req.rid] = req
        t0 = time.perf_counter()
        pr = self.engine.prefill(gr, prompt_len=self.prompt_len)
        dt = time.perf_counter() - t0
        start, finish = self._prefill_line.reserve(now, dt)
        t = self.transfer.send(pr, finish)
        tracer = getattr(ctx, "tracer", None)
        if tracer is not None and tracer.enabled:
            s = tracer.begin("prefill", start,
                             resource="disagg.prefill", rid=req.rid,
                             plen=pr.plen, kv_bytes=pr.kv_bytes)
            tracer.end(s, finish)
            if t.start_t > t.send_t:
                w = tracer.begin("transfer.wait", t.send_t, rid=req.rid)
                tracer.end(w, t.start_t)
            x = tracer.begin("transfer", t.start_t,
                             resource="disagg.link", rid=req.rid,
                             bytes=t.n_bytes)
            tracer.end(x, t.arrive_t)
        return []

    def _deliver(self, now: float, *, everything: bool = False) -> None:
        landed = (self.transfer.deliver_all() if everything
                  else self.transfer.deliver(now))
        if not landed:
            return
        session = self._ensure_session()
        for t in landed:
            self.engine.insert(t.result, session)

    def _advance_once(self, now: float, ctx=None) -> list[Completion]:
        t0 = time.perf_counter()
        finished = self._session.advance()
        self._pending_dt += time.perf_counter() - t0
        if not finished:
            # windows that complete nothing fold into the next
            # completing window's span
            return []
        start = max(now, self._free_at)
        finish = start + self._pending_dt
        self._free_at = finish
        self._pending_dt = 0.0
        reqs = [self._by_rid.pop(g.rid) for g in finished]
        extras = dict(self._session.stats())
        extras["transfer"] = self.transfer.stats()
        tracer = getattr(ctx, "tracer", None) if ctx is not None else None
        if tracer is not None and tracer.enabled:
            # one span per completing window group; non-completing
            # windows folded their walltime into this span already
            s = tracer.begin("decode.window", start,
                             resource="disagg.decode",
                             finished=len(finished),
                             active=self._session.n_active)
            tracer.end(s, finish)
        return [Completion(requests=reqs,
                           outputs=[list(g.generated)
                                    for g in finished],
                           path=PATH_GENERATE, t_start=start,
                           t_finish=finish, extras=extras)]

    def step(self, now, ctx) -> list[Completion]:
        self._deliver(now)
        if (not self.advance_on_arrival or self._session is None
                or self._session.idle):
            return []
        return self._advance_once(now, ctx)

    def drain(self, now, ctx) -> list[Completion]:
        # fast-forward past the slowest in-flight transfer — and past
        # any link outage still in effect — so the decode side can run
        # dry on one monotone clock
        horizon = max([now, self.transfer.outage_until]
                      + [t.arrive_t for t in self.transfer.inflight])
        self._deliver(horizon, everything=True)
        if self._session is None:
            return []
        out: list[Completion] = []
        while not self._session.idle:
            out.extend(self._advance_once(horizon, ctx))
        return out
