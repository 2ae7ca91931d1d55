"""``repro.serving.api`` — the unified serving surface.

One request/response lifecycle across all four execution paths:

    enqueue -> proxy triage -> admission (pluggable middleware)
            -> route (direct | dynamic-batch | gated-in-graph
                      | continuous-decode)
            -> execute -> per-request telemetry -> respond

The pieces:

  - :class:`InferRequest` / :class:`InferResponse` — the shared typed
    request/response pair every path consumes and produces.
  - :class:`EnginePort` — the protocol (``warmup / triage / submit /
    step / drain / capabilities / load``) an execution backend
    implements.  Adapters for the four existing engines live in
    ``repro.serving.adapters``.
  - :class:`ServingMiddleware` — lifecycle hooks.  The paper's
    closed-loop admission controller plugs in as
    :class:`AdmissionMiddleware` (not as an engine constructor arg), so
    policies compose with any backend.
  - :class:`Server` — the orchestrator that owns the lifecycle,
    virtual-time bookkeeping (busy/span), energy feedback, and the
    per-request :class:`~repro.telemetry.request_log.RequestLog`.

Time is *virtual*: requests carry ``arrival_s`` and simulated backends
advance the clock with modelled latencies while live backends advance
it with measured walltimes, so the discrete-event simulator and real
engines share one code path (and one telemetry story).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.controller import AdmissionController, Decision
from repro_torch.core.energy import EnergyModel
from repro_torch.core.threshold import AdaptiveThreshold
from repro_torch.serving.workload import Request
from repro_torch.telemetry.metrics import NULL_METRICS
from repro_torch.telemetry.request_log import RequestLog
from repro_torch.telemetry.trace import NULL_TRACER

# -- canonical path names ---------------------------------------------------
PATH_DIRECT = "direct"
PATH_DYNAMIC_BATCH = "dynamic-batch"
PATH_GATED = "gated-in-graph"
PATH_CONTINUOUS = "continuous-decode"
PATH_GENERATE = "generate"
PATH_AUTO = "auto"
PATH_SKIP = "skip"
PATH_REJECT = "reject"                   # shed: expired / retry-exhausted

ALL_PATHS = (PATH_DIRECT, PATH_DYNAMIC_BATCH, PATH_GATED,
             PATH_CONTINUOUS, PATH_GENERATE)

_PATH_ALIASES = {
    "batched": PATH_DYNAMIC_BATCH,       # legacy simulator name
    "gated": PATH_GATED,
    "continuous": PATH_CONTINUOUS,
}


def canonical_path(path: str) -> str:
    """Map legacy/short path names onto the canonical set + auto."""
    p = _PATH_ALIASES.get(path, path)
    if p not in ALL_PATHS + (PATH_AUTO,):
        raise ValueError(f"unknown path {path!r}; expected one of "
                         f"{ALL_PATHS + (PATH_AUTO,)}")
    return p


# -- request / response -----------------------------------------------------

@dataclass
class InferRequest(Request):
    """The unified request: a classification payload (token ids) or a
    generation prompt.  Extends the workload ``Request`` wire type with
    execution hints, so plain workload streams stay accepted."""
    kind: str = "classify"             # "classify" | "generate"
    max_new: int = 16                  # generation budget (kind=generate)
    entropy_hint: float | None = None  # L(x) proxy known at enqueue time
    metadata: dict = field(default_factory=dict)
    deadline_s: float | None = None    # relative deadline; None = none
    sampling: Any = None               # SamplingParams (kind=generate);
                                       # None = engine default (greedy)


def request_expiry(req) -> float:
    """Absolute virtual time at which ``req`` expires (``inf`` for no
    deadline).  ``metadata['expires_at']`` overrides the relative
    ``deadline_s`` so a retried copy (whose ``arrival_s`` is the retry
    time) keeps the ORIGINAL absolute deadline."""
    meta = getattr(req, "metadata", None)
    if meta and "expires_at" in meta:
        return float(meta["expires_at"])
    d = getattr(req, "deadline_s", None)
    if d is None:
        return float("inf")
    return float(req.arrival_s) + float(d)


@dataclass
class InferResponse:
    """What every path returns for every request — including skipped
    ones (answered by the proxy head, path='skip')."""
    rid: int
    output: Any                        # class id | generated token list
    admitted: bool
    path: str
    arrival_s: float
    t_start: float
    t_finish: float
    batch_size: int = 1
    energy_j: float = 0.0              # modelled joules share
    decision: Decision | None = None   # host-side admission record
    label: int | None = None
    telemetry: dict = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.t_finish - self.arrival_s


# -- engine port ------------------------------------------------------------

@dataclass
class TriageResult:
    """Output of the cheap proxy pass over one request."""
    L: float | None                    # uncertainty proxy; None = no
    proxy_output: Any = None           # host-side triage (in-graph gate)
    cost_s: float = 0.0                # triage walltime (busy-time)


@dataclass
class Completion:
    """A finished execution unit (one batch; size 1 on the direct
    path).  ``admit_mask`` is set by in-graph-admission engines whose
    gate decided on device."""
    requests: list
    outputs: list
    path: str
    t_start: float
    t_finish: float
    admit_mask: list | None = None
    extras: dict = field(default_factory=dict)       # batch-level
    per_request: list | None = None                  # dict per request

    @property
    def size(self) -> int:
        return len(self.requests)


@dataclass(frozen=True)
class EngineCapabilities:
    name: str
    kind: str = "classify"                     # "classify" | "generate"
    paths: tuple = (PATH_DIRECT,)
    in_graph_admission: bool = False           # gate runs inside the jit


@dataclass
class LoadState:
    queue_depth: int = 0
    batch_fill: float = 0.0


# nominal per-request service time for the LoadState-derived pressure
# default — engines that know their service model report real backlog
# seconds instead
DEFAULT_SERVICE_S = 0.01


def load_pressure(load: LoadState,
                  service_s: float = DEFAULT_SERVICE_S) -> float:
    """The ``LoadState``-derived ``pressure(now)`` default: queued
    requests scaled by a nominal service time.  Engines whose backends
    expose a free-at horizon (a ``ServiceLine``/``SlotClock`` core)
    report the real backlog seconds instead."""
    return float(load.queue_depth) * service_s


def engine_pressure(engine, now: float) -> float:
    """``engine.pressure(now)`` with the ``LoadState``-derived default
    for engines that predate the protocol extension."""
    fn = getattr(engine, "pressure", None)
    if callable(fn):
        return float(fn(now))
    return load_pressure(engine.load())


@runtime_checkable
class EnginePort(Protocol):
    """What a backend must provide to serve behind :class:`Server`.

    ``submit``/``step``/``drain`` return completed :class:`Completion`s
    (possibly none — e.g. a batcher absorbing the request); the server
    owns everything around them (triage routing, admission, telemetry).

    ``pressure(now)`` is the uniform congestion signal the fleet
    router/autoscaler/admission read: seconds of queued + in-flight
    work at ``now``.  It must be side-effect-free (polling never
    advances clocks or queues).  Engines without a service model may
    return the :func:`load_pressure` default; callers integrating
    third-party engines should go through :func:`engine_pressure`,
    which supplies that default for them.
    """

    def capabilities(self) -> EngineCapabilities: ...

    def warmup(self, ctx: "ServerContext") -> None: ...

    def triage(self, req, now: float,
               ctx: "ServerContext") -> TriageResult: ...

    def submit(self, req, path: str, now: float,
               ctx: "ServerContext") -> list[Completion]: ...

    def step(self, now: float, ctx: "ServerContext") -> list[Completion]: ...

    def drain(self, now: float,
              ctx: "ServerContext") -> list[Completion]: ...

    def load(self) -> LoadState: ...

    def pressure(self, now: float) -> float: ...


# -- middleware -------------------------------------------------------------

class ServingMiddleware:
    """Lifecycle hooks; subclass and override what you need.

    ``on_triage`` may return a :class:`Decision`; with several
    middleware the LAST non-None decision wins (later middleware can
    veto earlier ones).  ``on_completion`` receives the finished
    completion (None for skips) plus the responses minted from it.
    """

    def on_enqueue(self, req, ctx: "ServerContext") -> None:
        return None

    def on_triage(self, req, triage: TriageResult,
                  ctx: "ServerContext") -> Decision | None:
        return None

    def on_decision(self, req, decision: Decision,
                    ctx: "ServerContext") -> None:
        """Observes the FINAL admission decision (after any override
        by later middleware)."""
        return None

    def on_completion(self, completion: Completion | None,
                      responses: list[InferResponse],
                      ctx: "ServerContext") -> None:
        return None

    def on_finish(self, server: "Server",
                  ctx: "ServerContext") -> None:
        return None


@dataclass
class AdmissionMiddleware(ServingMiddleware):
    """The paper's closed-loop controller as pluggable middleware.

    Triage-time: feeds congestion state (queue depth, batch fill,
    recent P95) into the controller and evaluates J(x) vs tau(t).
    Completion-time: closes the loop — modelled joules from the batch
    walltime feed the EnergyMeter EWMA that the NEXT decision's E(x)
    reads.  For in-graph-admission engines it instead supplies the
    (tau, e_norm, c_norm) snapshot via :meth:`snapshot` and folds the
    device-side mask back into the controller's statistics."""
    controller: AdmissionController
    _pending: Decision | None = field(default=None, init=False)

    def on_enqueue(self, req, ctx):
        # feed congestion on EVERY path — the in-graph gate's C(x) leg
        # reads this state through snapshot(), not through on_triage
        cong = self.controller.congestion
        load = ctx.engine.load()
        cong.queue_depth = load.queue_depth
        cong.batch_fill = load.batch_fill
        if ctx.lat_window:
            cong.p95_latency_s = float(
                np.percentile(ctx.lat_window[-256:], 95))

    def on_triage(self, req, triage, ctx):
        if triage.L is None:
            return None                 # nothing to triage on
        self._pending = self.controller.decide(float(triage.L), ctx.now)
        return self._pending

    def on_decision(self, req, decision, ctx):
        d, self._pending = self._pending, None
        if d is None or decision is d:
            return
        # a later middleware overrode the controller: reconcile the
        # closed-loop statistics with what was actually served (the
        # adaptive threshold re-observes the served outcome, slightly
        # overweighting overridden requests in its EWMA)
        self.controller.n_admitted += (int(decision.admit)
                                       - int(d.admit))
        if isinstance(self.controller.threshold, AdaptiveThreshold):
            self.controller.threshold.observe(decision.admit)

    def on_completion(self, completion, responses, ctx):
        if completion is None:
            return
        j = ctx.energy_model.p_active * (completion.t_finish
                                         - completion.t_start)
        # marginal energy is per unit of ADMITTED work (the full model
        # ran only for those); matches serve_gated's offline loop
        n = (completion.size if completion.admit_mask is None
             else int(sum(completion.admit_mask)))
        self.controller.meter.record(j, n_requests=n)
        if completion.admit_mask is not None:
            self.controller.observe_external(completion.admit_mask)

    def snapshot(self, t: float) -> tuple[float, float, float]:
        return self.controller.snapshot(t)


@dataclass
class TelemetryMiddleware(ServingMiddleware):
    """Mirrors every response into a :class:`RequestLog` and optionally
    a Tracker run (per-request audit rows)."""
    log: RequestLog = field(default_factory=RequestLog)
    run: Any = None                    # telemetry.Run, optional

    def on_completion(self, completion, responses, ctx):
        for r in responses:
            self.log.add(r)

    def on_finish(self, server, ctx):
        self.log.busy_s = server.busy_s
        self.log.span_s = server.span_s
        self.flush()

    def flush(self) -> None:
        if self.run is not None:
            self.log.log_to(self.run)


# -- server -----------------------------------------------------------------

@dataclass
class CrashReport:
    """What :meth:`Server.crash_now` salvaged from a dying replica.

    ``stranded`` holds queued requests that never started; ``lost_rids``
    names requests whose optimistically-minted future responses were
    withdrawn (the virtual-time engines mint completions at submit with
    a future ``t_finish`` — work past the crash instant never actually
    happened).  ``wasted_j`` is the modelled joules burned on partial
    executions that produced nothing."""
    stranded: list = field(default_factory=list)
    lost_rids: list = field(default_factory=list)
    wasted_j: float = 0.0

    @property
    def n_lost(self) -> int:
        return len(self.stranded) + len(self.lost_rids)


@dataclass
class ServerConfig:
    """Lifecycle/routing knobs (engine-specific knobs live on the
    adapters)."""
    path: str = PATH_AUTO
    auto_queue_threshold: int = 4      # route to the batcher when loaded
    n_chips: int = 1
    energy_model: EnergyModel = field(default_factory=EnergyModel)


@dataclass
class ServerContext:
    """Shared mutable state middleware and engines may read."""
    config: ServerConfig
    engine: Any
    energy_model: EnergyModel
    n_chips: int = 1
    now: float = 0.0
    busy_s: float = 0.0
    lat_window: list = field(default_factory=list)
    snapshot: Callable[[float], tuple] | None = None
    extras: dict = field(default_factory=dict)
    tracer: Any = NULL_TRACER          # telemetry.trace recorder
    metrics: Any = NULL_METRICS        # telemetry.metrics registry


def _default_snapshot(t: float) -> tuple[float, float, float]:
    # no admission middleware = open loop: a tau no J can violate
    # (rule 'le'; a 'ge'-rule gate needs a real admission middleware)
    return (float("inf"), 0.5, 0.0)


@dataclass
class Server:
    """The one serving orchestrator.

    ``serve(requests)`` drives the full lifecycle for any
    :class:`EnginePort`; afterwards ``summary()`` reports the shared
    latency/throughput/energy/admission metrics and ``responses`` holds
    the per-request records.

    The lifecycle is also exposed incrementally — ``start()`` /
    ``push(req)`` / ``poke(now)`` / ``finish(now)`` — so an external
    driver (the fleet simulator in ``repro.fleet``) can interleave many
    servers on one virtual clock, routing each request to a replica at
    arrival time.  ``serve`` is exactly start + push-per-request +
    finish.
    """
    engine: EnginePort
    config: ServerConfig = field(default_factory=ServerConfig)
    middleware: list = field(default_factory=list)
    tracer: Any = None                 # telemetry.trace.Tracer; None=off
    metrics: Any = None                # telemetry.metrics registry; None=off
    name: str = ""                     # trace-resource prefix (fleet replica)

    responses: list = field(default_factory=list, init=False)
    log: RequestLog = field(init=False)
    busy_s: float = field(default=0.0, init=False)
    span_s: float = field(default=1e-9, init=False)
    ctx: ServerContext = field(init=False, repr=False)

    def __post_init__(self):
        self.log = RequestLog(energy_model=self.config.energy_model,
                              n_chips=self.config.n_chips)
        self._started = False
        self._closed = False

    def _ensure_open(self) -> None:
        """Auto-start a NEVER-started server (push-first convenience),
        but refuse to silently wipe a finished session's telemetry."""
        if self._started:
            return
        if self._closed:
            raise RuntimeError(
                "session already finished — call start() to begin a "
                "new run (this would silently wipe the previous "
                "session's responses)")
        self.start()

    # -- lifecycle ----------------------------------------------------------
    def serve(self, requests: Iterable[Request]) -> list[InferResponse]:
        self.start()
        for req in requests:
            self.push(req)
        return self.finish()

    def start(self) -> "Server":
        """Open an incremental serving session (resets all state)."""
        self.log = RequestLog(energy_model=self.config.energy_model,
                              n_chips=self.config.n_chips)
        self._caps = self.engine.capabilities()
        ctx = ServerContext(config=self.config, engine=self.engine,
                            energy_model=self.config.energy_model,
                            n_chips=self.config.n_chips,
                            tracer=(self.tracer if self.tracer is not None
                                    else NULL_TRACER),
                            metrics=(self.metrics if self.metrics is not None
                                     else NULL_METRICS))
        self._roots: dict[int, Any] = {}   # rid -> open root span
        for mw in self.middleware:
            snap = getattr(mw, "snapshot", None)
            if callable(snap):
                ctx.snapshot = snap
        if ctx.snapshot is None:
            ctx.snapshot = _default_snapshot
        self.ctx = ctx
        self._out: list[InferResponse] = []
        self._decisions: dict[int, Decision] = {}
        self._first_arrival: float | None = None
        self._last_arrival: float = 0.0
        self._started = True
        self._closed = False
        self.engine.warmup(ctx)
        return self

    def push(self, req) -> list[InferResponse]:
        """Run one request through triage/admission/routing; returns the
        responses COMPLETED by this arrival (possibly none — e.g. the
        batcher absorbing the request, or several flushed batches)."""
        self._ensure_open()
        ctx, caps = self.ctx, self._caps
        n0 = len(self._out)
        now = float(req.arrival_s)
        if self._first_arrival is None:
            self._first_arrival = now
        self._last_arrival = max(self._last_arrival, now)
        ctx.now = now
        # flush work whose deadline passed before this arrival
        self._absorb(self.engine.step(now, ctx), ctx, self._decisions,
                     self._out)

        # deadline shedding: an expired request is rejected-with-reason
        # and NEVER executed — no triage, no queue slot, no joules
        if now >= request_expiry(req):
            self._reject(req, now, "deadline-expired")
            return self._out[n0:]

        tracer, root = ctx.tracer, None
        if tracer.enabled:
            # root span: covers triage -> admission -> queue -> execute;
            # closed in _absorb (or below for skips)
            root = tracer.begin("request", now, rid=req.rid,
                                kind=getattr(req, "kind", "classify"))
            self._roots[req.rid] = root

        for mw in self.middleware:
            mw.on_enqueue(req, ctx)

        # proxy triage (cheap uncertainty signal; busy-time cost)
        tri = self.engine.triage(req, now, ctx)
        ctx.busy_s += tri.cost_s
        if tracer.enabled:
            tracer.span("triage", now, now + tri.cost_s, parent=root,
                        L=tri.L, cost_s=tri.cost_s)

        # admission: last non-None middleware decision wins;
        # in-graph engines gate on device instead
        decision = None
        if not caps.in_graph_admission:
            for mw in self.middleware:
                d = mw.on_triage(req, tri, ctx)
                if d is not None:
                    decision = d
        if decision is not None:
            self._decisions[req.rid] = decision
            for mw in self.middleware:
                mw.on_decision(req, decision, ctx)
            if tracer.enabled:
                tracer.event("admission", now, parent=root,
                             admit=bool(decision.admit),
                             J=float(decision.J), tau=float(decision.tau))

        if decision is not None and not decision.admit:
            # "skip or respond from cache": the proxy answers
            resp = InferResponse(
                rid=req.rid, output=tri.proxy_output, admitted=False,
                path=PATH_SKIP, arrival_s=now, t_start=now,
                t_finish=now + tri.cost_s, decision=decision,
                label=getattr(req, "label", None))
            ctx.lat_window.append(tri.cost_s)
            self._out.append(resp)
            self.log.add(resp)
            if root is not None:
                tracer.end(root, resp.t_finish, path=PATH_SKIP,
                           admitted=False)
                self._roots.pop(req.rid, None)
            if ctx.metrics.enabled:
                self._observe_response(resp, ctx)
            for mw in self.middleware:
                mw.on_completion(None, [resp], ctx)
            return self._out[n0:]

        path = self._route(caps, ctx)
        self._absorb(self.engine.submit(req, path, now, ctx),
                     ctx, self._decisions, self._out)
        return self._out[n0:]

    def poke(self, now: float) -> list[InferResponse]:
        """Advance the engine's clock without a new arrival (flush
        expired queue windows).  The fleet driver calls this on every
        replica at each fleet-level event so idle replicas still honour
        their batching deadlines."""
        self._ensure_open()
        ctx = self.ctx
        n0 = len(self._out)
        ctx.now = max(ctx.now, float(now))
        self._absorb(self.engine.step(ctx.now, ctx), ctx,
                     self._decisions, self._out)
        return self._out[n0:]

    def drain_now(self, now: float | None = None) -> list[InferResponse]:
        """Flush ALL queued work at ``now`` without closing the session
        (the fleet autoscaler drains a replica mid-run; it may be
        revived and receive traffic again afterwards)."""
        self._ensure_open()
        ctx = self.ctx
        n0 = len(self._out)
        t = self._last_arrival if now is None else float(now)
        ctx.now = max(ctx.now, t)
        self._absorb(self.engine.drain(ctx.now, ctx), ctx,
                     self._decisions, self._out)
        return self._out[n0:]

    def finish(self, now: float | None = None) -> list[InferResponse]:
        """Drain, finalise span/busy accounting, fire ``on_finish``."""
        if not self._started:
            # restarting here would silently wipe the previous
            # session's responses/summary
            raise RuntimeError(
                "finish() without an open session — call start()/push() "
                "first")
        ctx = self.ctx
        last = self._last_arrival if now is None else float(now)
        ctx.now = max(ctx.now, last)
        self._absorb(self.engine.drain(ctx.now, ctx), ctx,
                     self._decisions, self._out)

        out = self._out
        first = (self._first_arrival if self._first_arrival is not None
                 else 0.0)
        finish = max((r.t_finish for r in out), default=first)
        if ctx.tracer.enabled and self._roots:
            # drain completes everything; a leftover root is a lost
            # request — close it flagged so the validator can object
            for root in self._roots.values():
                ctx.tracer.end(root, ctx.now, error="unfinished")
            self._roots.clear()
        self.span_s = max(finish - first, 1e-9)
        self.busy_s = ctx.busy_s
        self.log.busy_s = ctx.busy_s
        self.log.span_s = self.span_s
        self.responses = out
        self._started = False
        self._closed = True
        for mw in self.middleware:
            mw.on_finish(self, ctx)
        return out

    # -- failure surface -----------------------------------------------------
    def _reject(self, req, now: float, reason: str) -> InferResponse:
        """Mint a rejection-with-reason response (path='reject'); the
        request is counted exactly once and never executed."""
        ctx = self.ctx
        resp = InferResponse(
            rid=req.rid, output=None, admitted=False, path=PATH_REJECT,
            arrival_s=float(req.arrival_s), t_start=now, t_finish=now,
            label=getattr(req, "label", None),
            telemetry={"reason": reason})
        self._out.append(resp)
        self.log.add(resp)
        tracer = ctx.tracer
        if tracer.enabled:
            root = self._roots.pop(req.rid, None)
            if root is not None:
                tracer.end(root, now, path=PATH_REJECT, reason=reason)
            else:
                tracer.event("reject", now, rid=req.rid, reason=reason)
        if ctx.metrics.enabled:
            self._observe_response(resp, ctx)
            ctx.metrics.counter(
                "serving_rejections_total",
                "requests shed without execution, by reason").inc(
                reason=reason, engine=self._caps.name)
        for mw in self.middleware:
            mw.on_completion(None, [resp], ctx)
        return resp

    def shed_expired(self, now: float) -> list[InferResponse]:
        """Drop queued (not yet started) requests whose deadline has
        passed — the joules they would have burned are saved.  Engines
        without a cancellable queue shed nothing here (their expired
        work is caught at push time instead)."""
        self._ensure_open()
        n0 = len(self._out)
        cancel = getattr(self.engine, "cancel_queued", None)
        if callable(cancel):
            t = float(now)
            for r in cancel(lambda q: t >= request_expiry(q)):
                self._reject(r, t, "deadline-expired")
        return self._out[n0:]

    def crash_now(self, now: float) -> CrashReport:
        """The replica dies at ``now``: queued work is stranded,
        in-flight work is lost, partially-burned joules are wasted.

        The virtual-time engines mint completions at submit time with
        future ``t_finish``; a crash must claw those back — every
        response with ``t_finish > now`` is withdrawn from the output
        and the request log, its unburned busy-time refunded and its
        burned share booked as ``wasted_j``.  The caller (the fleet
        loop) decides retry vs reject for everything reported."""
        self._ensure_open()
        ctx = self.ctx
        t = float(now)
        ctx.now = max(ctx.now, t)
        report = CrashReport()

        cancel = getattr(self.engine, "cancel_queued", None)
        if callable(cancel):
            report.stranded = list(cancel(None))

        p_active = ctx.energy_model.p_active
        kept: list[InferResponse] = []
        for r in self._out:
            if r.t_finish <= t or r.path in (PATH_SKIP, PATH_REJECT):
                kept.append(r)
                continue
            size = max(r.batch_size, 1)
            burned = max(min(t, r.t_finish) - r.t_start, 0.0) / size
            refund = (r.t_finish - r.t_start) / size - burned
            ctx.busy_s -= refund
            report.wasted_j += p_active * burned
            report.lost_rids.append(r.rid)
            self.log.discard(r)
        self._out[:] = kept

        tracer = ctx.tracer
        if tracer.enabled:
            for req in report.stranded:
                root = self._roots.pop(req.rid, None)
                if root is not None:
                    tracer.end(root, t, error="crashed")
        on_crash = getattr(self.engine, "on_crash", None)
        if callable(on_crash):
            on_crash(t)
        if ctx.metrics.enabled and report.n_lost:
            ctx.metrics.counter(
                "serving_crash_lost_total",
                "requests stranded or withdrawn by a crash").inc(
                value=float(report.n_lost), engine=self._caps.name)
        return report

    # -- internals ----------------------------------------------------------
    def _route(self, caps: EngineCapabilities, ctx) -> str:
        p = canonical_path(self.config.path)
        if p != PATH_AUTO:
            if p not in caps.paths:
                raise ValueError(
                    f"engine {caps.name!r} cannot serve path {p!r} "
                    f"(supports {caps.paths})")
            return p
        if len(caps.paths) == 1:
            return caps.paths[0]
        if (PATH_DYNAMIC_BATCH in caps.paths
                and self.engine.load().queue_depth
                >= self.config.auto_queue_threshold):
            return PATH_DYNAMIC_BATCH
        return (PATH_DIRECT if PATH_DIRECT in caps.paths
                else caps.paths[0])

    def _observe_response(self, resp: InferResponse, ctx) -> None:
        m = ctx.metrics
        engine = self._caps.name
        m.counter("serving_requests_total",
                  "responses minted, by path/admission").inc(
            path=resp.path, admitted=str(bool(resp.admitted)),
            engine=engine)
        m.histogram("serving_latency_s",
                    "arrival-to-finish latency").observe(
            resp.latency_s, path=resp.path, engine=engine)
        m.counter("serving_energy_j_total",
                  "modelled joules attributed to responses").inc(
            resp.energy_j, path=resp.path, engine=engine)

    def _absorb(self, completions, ctx, decisions, out) -> None:
        tracer = ctx.tracer
        for comp in completions or ():
            dt = comp.t_finish - comp.t_start
            ctx.busy_s += dt
            j_total = ctx.energy_model.p_active * dt
            if tracer.enabled:
                # service occupancy on the engine's line: one slice per
                # completion, on a per-(replica, path) resource track
                attrs = {"batch": comp.size}
                flush = comp.extras.get("flush") if comp.extras else None
                if flush:
                    attrs["flush"] = flush
                res = (f"{self.name}:{comp.path}" if self.name
                       else comp.path)
                tracer.span("execute", comp.t_start, comp.t_finish,
                            resource=res, **attrs)
            resps = []
            for i, r in enumerate(comp.requests):
                admitted = (True if comp.admit_mask is None
                            else bool(comp.admit_mask[i]))
                telemetry = dict(comp.extras) if comp.extras else {}
                if comp.per_request is not None:
                    telemetry.update(comp.per_request[i])
                resp = InferResponse(
                    rid=r.rid, output=comp.outputs[i], admitted=admitted,
                    path=comp.path, arrival_s=float(r.arrival_s),
                    t_start=comp.t_start, t_finish=comp.t_finish,
                    batch_size=comp.size,
                    energy_j=j_total / max(comp.size, 1),
                    decision=decisions.get(r.rid),
                    label=getattr(r, "label", None),
                    telemetry=telemetry)
                ctx.lat_window.append(resp.latency_s)
                out.append(resp)
                resps.append(resp)
                self.log.add(resp)
                if tracer.enabled:
                    root = self._roots.pop(r.rid, None)
                    if root is not None:
                        if comp.t_start > resp.arrival_s:
                            tracer.span("queue.wait", resp.arrival_s,
                                        comp.t_start, parent=root)
                        tracer.end(root, comp.t_finish, path=comp.path,
                                   admitted=admitted)
                if ctx.metrics.enabled:
                    self._observe_response(resp, ctx)
            for mw in self.middleware:
                mw.on_completion(comp, resps, ctx)

    # -- signals ------------------------------------------------------------
    def pressure(self, now: float) -> float:
        """The engine's backlog seconds at ``now`` (the fleet's uniform
        congestion signal); side-effect-free."""
        return engine_pressure(self.engine, now)

    # -- reporting ----------------------------------------------------------
    @property
    def energy_j(self) -> float:
        return self.log.energy_j

    def summary(self) -> dict:
        return self.log.summary()
