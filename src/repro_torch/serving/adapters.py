"""EnginePort adapters for the classify path, ported from
``repro.serving.adapters``.

  - :class:`OracleEngine` — the discrete-event simulator backend:
    precomputed model behaviour (``Oracle``) + virtual-time dual-path
    scheduling (``DirectPath`` / ``DynamicBatcher``).  Host code only.
  - :class:`ClassifierEngineAdapter` — live ``ClassifierEngine``
    execution (full + proxy models, measured walltimes) on the
    ``direct`` and ``dynamic-batch`` paths.
  - :class:`GatedEngineAdapter` — the gated step: admission happens ON
    THE DEVICE from the (tau, e_norm, c_norm) snapshot the admission
    middleware supplies; the mask flows back into the controller's
    statistics.
  - :class:`ContinuousEngineAdapter` — generation through the slot-pool
    decoder's incremental session (the generate path).
  - :class:`CallableEngineAdapter` — any ``payload -> output`` function
    (ResNet-18 in the smoke) on the direct path, timed per call.

The invariants are the reference's (virtual time on one monotone
clock, admission outside the engine, every submitted request in
exactly one completion, side-effect-free ``load``/``pressure``).  Live
adapters run each new shape once untimed: on the card that first call
also builds the CUDA kernel and creates the CUDA context, so a
measured span is always a step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.serving.api import (PATH_CONTINUOUS, PATH_DIRECT,
                                     PATH_DYNAMIC_BATCH, PATH_GATED,
                                     Completion,
                                     EngineCapabilities, LoadState,
                                     TriageResult, load_pressure)
from repro_torch.serving.batcher import (Batch, BatchQueue, DirectPath,
                                         DynamicBatcher, ServiceLine)
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            GenRequest)
from repro_torch.serving.engine import ClassifierEngine, bucket_size
from repro_torch.serving.gated import GateParams, make_gated_classify_step
from repro_torch.serving.simulator import Oracle


# ---------------------------------------------------------------------------
# simulator backend
# ---------------------------------------------------------------------------

@dataclass
class OracleEngine:
    """Virtual-time backend over precomputed per-request behaviour."""
    oracle: Oracle
    direct: DirectPath
    batched: DynamicBatcher

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="oracle-sim", kind="classify",
                                  paths=(PATH_DIRECT, PATH_DYNAMIC_BATCH))

    def warmup(self, ctx) -> None:
        self.direct.reset()
        self.batched.reset()

    def load(self) -> LoadState:
        return LoadState(queue_depth=self.batched.queue_depth,
                         batch_fill=self.batched.fill)

    def pressure(self, now: float) -> float:
        # both lines back one node: committed work on either path plus
        # a modelled step over whatever the batcher still queues
        return self.direct.backlog(now) + self.batched.backlog(now)

    def triage(self, req, now, ctx) -> TriageResult:
        lat = self.oracle.proxy_latency
        return TriageResult(
            L=float(self.oracle.entropy[req.rid]),
            proxy_output=int(self.oracle.proxy_pred[req.rid]),
            cost_s=lat.step_time(1) if lat is not None else 0.0)

    def _completion(self, b: Batch, path: str) -> Completion:
        return Completion(
            requests=b.requests,
            outputs=[int(self.oracle.full_pred[r.rid])
                     for r in b.requests],
            path=path, t_start=b.t_start, t_finish=b.t_finish,
            extras={"flush": b.reason})

    def submit(self, req, path, now, ctx) -> list[Completion]:
        if path == PATH_DIRECT:
            return [self._completion(self.direct.serve(req, now),
                                     PATH_DIRECT)]
        return [self._completion(b, PATH_DYNAMIC_BATCH)
                for b in self.batched.submit(req, now)]

    def step(self, now, ctx) -> list[Completion]:
        return [self._completion(b, PATH_DYNAMIC_BATCH)
                for b in self.batched.poll(now)]

    def drain(self, now, ctx) -> list[Completion]:
        return [self._completion(b, PATH_DYNAMIC_BATCH)
                for b in self.batched.drain(now)]


# ---------------------------------------------------------------------------
# live classifier backend
# ---------------------------------------------------------------------------

@dataclass
class ClassifierEngineAdapter:
    """Real execution; measured walltimes advance the clock.

    Queueing/flush policy is the shared ``BatchQueue`` core and the
    node clock a ``ServiceLine`` — the SAME primitives the simulated
    engines wrap — so the only thing live about this adapter is that
    batch durations are measured, not modelled."""
    engine: ClassifierEngine
    max_batch: int = 32
    queue_window_s: float = 0.0       # <=0: flush on size / drain only
    triage_enabled: bool = True

    _window: BatchQueue = field(init=False, repr=False)
    _line: ServiceLine = field(init=False, repr=False)
    _warm: set = field(default_factory=set, init=False)
    # measured walltime of each full-model call (a direct request or a
    # batch), over every session of this adapter
    batch_times: list = field(default_factory=list, init=False)

    def __post_init__(self):
        self._window = BatchQueue(max_batch_size=self.max_batch,
                                  queue_window_s=self.queue_window_s)
        self._line = ServiceLine()

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="classifier", kind="classify",
                                  paths=(PATH_DIRECT, PATH_DYNAMIC_BATCH))

    def warmup(self, ctx) -> None:
        # warmed lazily per bucket (see _prime) — but a fresh session
        # starts with a clean queue and clock so a pool can be re-run
        self._window.reset()
        self._line.reset()

    def _prime(self, kind: str, toks: np.ndarray) -> None:
        """Run the call once untimed so the first *measured* walltime
        is a step, not a kernel build or context creation."""
        key = (kind, bucket_size(len(toks)))
        if key in self._warm:
            return
        self._warm.add(key)
        if kind == "proxy":
            self.engine.proxy_scores(toks)
        else:
            self.engine.classify(toks)

    def load(self) -> LoadState:
        return LoadState(queue_depth=self._window.queue_depth,
                         batch_fill=self._window.fill)

    def pressure(self, now: float) -> float:
        # measured-walltime horizon + nominal estimate for the queue
        # (live walltimes are only known after execution)
        return self._line.backlog(now) + load_pressure(self.load())

    def triage(self, req, now, ctx) -> TriageResult:
        if not self.triage_enabled:
            return TriageResult(L=None)
        toks = np.asarray(req.payload)[None]
        self._prime("proxy", toks)
        preds, ents, _, dt = self.engine.proxy_scores(toks)
        return TriageResult(L=float(ents[0]),
                            proxy_output=int(preds[0]), cost_s=dt)

    def submit(self, req, path, now, ctx) -> list[Completion]:
        if path == PATH_DIRECT:
            toks = np.asarray(req.payload)[None]
            self._prime("full", toks)
            preds, dt = self.engine.classify(toks)
            self.batch_times.append(dt)
            start, finish = self._line.reserve(now, dt)
            return [Completion([req], [int(preds[0])], PATH_DIRECT,
                               start, finish)]
        return [self._execute(b) for b in self._window.submit(req, now)]

    def step(self, now, ctx) -> list[Completion]:
        return [self._execute(b) for b in self._window.poll(now)]

    def drain(self, now, ctx) -> list[Completion]:
        return [self._execute(b) for b in self._window.drain(now)]

    def _execute(self, b) -> Completion:
        toks = np.stack([np.asarray(r.payload) for r in b.requests])
        self._prime("full", toks)
        preds, dt = self.engine.classify(toks)
        self.batch_times.append(dt)
        start, finish = self._line.reserve(b.t_formed, dt)
        return Completion(b.requests, [int(p) for p in preds],
                          PATH_DYNAMIC_BATCH, start, finish,
                          extras={"flush": b.reason})


# ---------------------------------------------------------------------------
# gated backend
# ---------------------------------------------------------------------------

@dataclass
class GatedEngineAdapter:
    """Admission on the device: the controller middleware supplies
    (tau, e_norm, c_norm) per batch via ``ctx.snapshot``; the mask the
    device gate produced flows back through ``Completion.admit_mask``
    and the batch walltime feeds the EnergyMeter EWMA — the full closed
    loop, with static shapes.  ``params`` is the port ``DistilBERT``;
    it is moved to ``device`` (the card by default)."""
    cfg: dict
    params: object
    batch: int = 64
    capacity: int | None = None
    exit_layer: int = 2
    queue_window_s: float = 0.0       # 0 = flush on size / drain only
    gate: GateParams = field(default_factory=GateParams)
    device: object = "cuda"

    _step: Callable = field(init=False, repr=False)
    _window: BatchQueue = field(init=False, repr=False)
    _line: ServiceLine = field(init=False, repr=False)
    _warm: bool = field(default=False, init=False)
    batch_times: list = field(default_factory=list, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device).eval()
        self._step = make_gated_classify_step(
            {**self.cfg}, exit_layer=self.exit_layer,
            capacity=self.capacity, gate=self.gate, device=self.device)
        # the SAME window/size policy + free-at serialisation the sim
        # gated engine wraps; a partial batch runs (padded to static
        # shape) once the oldest queued request's window expires
        self._window = BatchQueue(max_batch_size=self.batch,
                                  queue_window_s=self.queue_window_s)
        self._line = ServiceLine()

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="gated", kind="classify",
                                  paths=(PATH_GATED,),
                                  in_graph_admission=True)

    def warmup(self, ctx) -> None:
        # fresh session, warm kernels: the warm flag survives on purpose
        self._window.reset()
        self._line.reset()

    def load(self) -> LoadState:
        return LoadState(queue_depth=self._window.queue_depth,
                         batch_fill=self._window.fill)

    def pressure(self, now: float) -> float:
        return self._line.backlog(now) + load_pressure(self.load())

    def triage(self, req, now, ctx) -> TriageResult:
        return TriageResult(L=None)    # proxy pass happens on the device

    def submit(self, req, path, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx)
                for b in self._window.submit(req, now)]

    def step(self, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx) for b in self._window.poll(now)]

    def drain(self, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx)
                for b in self._window.drain(now)]

    def _execute(self, b: Batch, ctx) -> Completion:
        reqs, t = b.requests, b.t_formed
        n = len(reqs)
        chunk = np.stack([np.asarray(r.payload) for r in reqs])
        if n < self.batch:             # static-shape pad
            pad = np.zeros((self.batch - n,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        tau, e_norm, c_norm = ctx.snapshot(t)
        if not self._warm:
            # untimed: the first call builds the kernel and creates the
            # CUDA context; timed, it would dominate latency/energy
            self._warm = True
            self._step(self.params, chunk, tau, e_norm, c_norm, n)
        synchronize(self.device)
        t0 = time.perf_counter()
        pred, admit, ent = self._step(self.params, chunk, tau, e_norm,
                                      c_norm, n)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.batch_times.append(dt)
        start, finish = self._line.reserve(t, dt)
        pred, admit, ent = (x[:n].cpu().numpy() for x in (pred, admit, ent))
        return Completion(
            requests=reqs,
            outputs=[int(p) for p in pred],
            path=PATH_GATED, t_start=start, t_finish=finish,
            admit_mask=[bool(a) for a in admit],
            extras={"tau": tau, "e_norm": e_norm, "c_norm": c_norm,
                    "flush": b.reason},
            per_request=[{"entropy": float(e)} for e in ent])


# ---------------------------------------------------------------------------
# continuous-decode backend
# ---------------------------------------------------------------------------

@dataclass
class ContinuousEngineAdapter:
    """Generation through the slot-pool decoder's INCREMENTAL session.

    The engine is built WITHOUT a controller — admission is the server
    middleware's job.  ``submit`` pushes the prompt into a live
    :class:`~repro_torch.serving.continuous.DecodeSession`; every
    ``step`` (each arrival) advances one ``sync_every``-step decode
    window, so decoding interleaves with the arrival stream and requests
    that finish mid-stream complete mid-stream.  ``drain`` runs the
    session dry.  Each window that completes requests is minted as one
    :class:`Completion` carrying the session's cumulative stats.  A
    request's ``sampling`` (``SamplingParams``; None = the engine's
    default) goes with it into the session."""
    engine: ContinuousBatchingEngine
    prompt_len: int | None = None

    _session: object = field(default=None, init=False)
    _by_rid: dict = field(default_factory=dict, init=False)
    _free_at: float = field(default=0.0, init=False)
    _pending_dt: float = field(default=0.0, init=False)
    _win_free_at: float = field(default=0.0, init=False)

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="continuous", kind="generate",
                                  paths=(PATH_CONTINUOUS,))

    def warmup(self, ctx) -> None:
        self._session = None
        self._by_rid.clear()
        self._free_at = 0.0
        self._pending_dt = 0.0
        self._win_free_at = 0.0

    def _ensure_session(self):
        if self._session is None:
            self._session = self.engine.start_session(self.prompt_len)
        return self._session

    def load(self) -> LoadState:
        if self._session is None:
            return LoadState()
        return LoadState(
            queue_depth=self._session.n_queued,
            batch_fill=self._session.n_active
            / max(self.engine.n_slots, 1))

    def pressure(self, now: float) -> float:
        return (max(self._free_at - now, 0.0)
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
                        eos_id=meta.get("eos_id"),
                        sampling=getattr(req, "sampling", None))
        self._ensure_session().push(gr)
        self._by_rid[req.rid] = req
        return []

    def _advance_once(self, now: float, ctx=None) -> list[Completion]:
        tracer = ctx.tracer if ctx is not None else None
        trace_on = tracer is not None and tracer.enabled
        s = self._session
        if trace_on:
            c0 = self.engine.decode_capture_count
            syncs0, steps0 = s.host_syncs, s.decode_steps
        t0 = time.perf_counter()
        finished = s.advance()
        dt = time.perf_counter() - t0
        self._pending_dt += dt
        if trace_on:
            # one window = one host sync; reads only counters that
            # advance() already synced
            wstart = max(now, self._win_free_at)
            wfinish = wstart + dt
            self._win_free_at = wfinish
            tracer.span("decode.window", wstart, wfinish,
                        resource="decode.device",
                        host_syncs=s.host_syncs - syncs0,
                        decode_steps=s.decode_steps - steps0,
                        active=s.n_active, finished=len(finished))
            # the counterpart of the reference's ``xla.compile`` event:
            # the window captured as a CUDA graph in this advance
            captures = self.engine.decode_capture_count - c0
            if captures:
                tracer.event("cuda.graph_capture", wstart,
                             resource="decode.device", count=captures)
        if not finished:
            # busy time of windows that completed nothing is folded
            # into the next completing window's span
            return []
        start = max(now, self._free_at)
        finish = start + self._pending_dt
        self._free_at = finish
        self._pending_dt = 0.0
        reqs = [self._by_rid.pop(g.rid) for g in finished]
        return [Completion(requests=reqs,
                           outputs=[list(g.generated) for g in finished],
                           path=PATH_CONTINUOUS, t_start=start,
                           t_finish=finish, extras=dict(s.stats()))]

    def step(self, now, ctx) -> list[Completion]:
        if self._session is None or self._session.idle:
            return []
        return self._advance_once(now, ctx)

    def drain(self, now, ctx) -> list[Completion]:
        if self._session is None:
            return []
        out: list[Completion] = []
        while not self._session.idle:
            out.extend(self._advance_once(now, ctx))
        return out


# ---------------------------------------------------------------------------
# generic callable backend
# ---------------------------------------------------------------------------

@dataclass
class CallableEngineAdapter:
    """Serve any ``payload -> output`` function on the direct path (no
    proxy head, so no host-side triage signal).  The first call runs
    untimed (on the card it creates the context and picks the
    convolution algorithms); each later call is timed with the card
    synchronised on both sides."""
    fn: Callable
    name: str = "callable"
    device: str | torch.device = "cuda"

    _free_at: float = field(default=0.0, init=False)
    _warm: bool = field(default=False, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name=self.name, kind="classify",
                                  paths=(PATH_DIRECT,))

    def warmup(self, ctx) -> None:
        self._free_at = 0.0

    def load(self) -> LoadState:
        return LoadState()

    def pressure(self, now: float) -> float:
        return max(self._free_at - now, 0.0)

    def triage(self, req, now, ctx) -> TriageResult:
        return TriageResult(L=None)

    @torch.inference_mode()
    def submit(self, req, path, now, ctx) -> list[Completion]:
        if not self._warm:
            self._warm = True
            self.fn(req.payload)
        synchronize(self.device)
        t0 = time.perf_counter()
        out = self.fn(req.payload)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        start = max(now, self._free_at)
        finish = start + dt
        self._free_at = finish
        return [Completion([req], [out], PATH_DIRECT, start, finish)]

    def step(self, now, ctx) -> list[Completion]:
        return []

    def drain(self, now, ctx) -> list[Completion]:
        return []
