"""Replicas — one serving node of the fleet.

A :class:`Replica` wraps a full ``repro_torch.serving.api.Server`` (engine +
its OWN admission controller + telemetry) with the fleet-facing state
the router and autoscaler read: lifecycle (``active`` / ``draining`` /
``stopped``), routed-request count, accumulated powered-on time, and
the per-replica marginal-energy signal (the controller's
``EnergyMeter`` EWMA, falling back to an analytic prior before any
traffic has been observed).

The module also provides the four *virtual-time* simulation engines a
heterogeneous fleet is built from — one per execution-path character.
None of them model scheduling themselves: they wrap the REAL
scheduling primitives the serving layer runs on (the way
``OracleEngine`` does), so the fleet sweep and the Table-2 benchmark
share one batching model:

  - :class:`SimDirectEngine`      ORT/FastAPI-style: serial, low fixed
                                  cost — a ``serving.batcher.DirectPath``.
  - :class:`SimBatchEngine`       Triton-style managed batching with
                                  ``preferred_sizes`` fidelity — a
                                  ``serving.batcher.DynamicBatcher``.
  - :class:`SimGatedEngine`       in-graph admission — the shared
                                  ``BatchQueue``/``ServiceLine`` cores
                                  plus the gate math extracted from
                                  ``serving.gated`` (``gate_objective``/
                                  ``gate_admit``); only admitted
                                  requests pay marginal compute.
  - :class:`SimContinuousEngine`  slot-pool decode — the
                                  ``serving.continuous.SlotClock``
                                  virtual-time core of the decode pool.

All four speak the full :class:`~repro_torch.serving.api.EnginePort`
protocol — including ``pressure(now)``, the uniform backlog-seconds
congestion signal the router and autoscaler read (``LoadState.
queue_depth`` alone misses a serial backend's backlog).  Behaviour
(predictions, proxy predictions, entropy) comes from a precomputed
:class:`~repro_torch.serving.simulator.Oracle`, so fleet sweeps over tens of
thousands of requests run in milliseconds and are exactly
reproducible.  For a fleet over the LIVE engines instead, see
``repro_torch.fleet.pool.build_live_fleet``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.controller import AdmissionController
from repro_torch.core.energy import EnergyModel
from repro_torch.core.landscape import LatencyModel
from repro_torch.faults.health import FAILED, HealthState
from repro_torch.serving.api import (PATH_CONTINUOUS, PATH_DIRECT,
                                     PATH_DYNAMIC_BATCH, PATH_GATED,
                                     AdmissionMiddleware, Completion,
                                     EngineCapabilities, LoadState, Server,
                                     ServerConfig, TriageResult)
from repro_torch.serving.batcher import (BatchQueue, DirectPath,
                                         DynamicBatcher, ServiceLine)
from repro_torch.serving.continuous import SlotClock
from repro_torch.serving.gated import GateParams, gate_admit, gate_objective
from repro_torch.serving.simulator import Oracle

# lifecycle states (drain is synchronous in virtual time, so there is
# no observable intermediate "draining" state)
ACTIVE = "active"
STOPPED = "stopped"

REPLICA_KINDS = (PATH_DIRECT, PATH_DYNAMIC_BATCH, PATH_GATED,
                 PATH_CONTINUOUS)


# ---------------------------------------------------------------------------
# virtual-time fleet engines
# ---------------------------------------------------------------------------

@dataclass
class _SimEngineBase:
    """Shared oracle-backed triage + bookkeeping.

    ``warmup`` (called by ``Server.start``) resets the virtual clock,
    so a replica — and therefore a whole pool — can serve a fresh run.
    """
    oracle: Oracle
    latency: LatencyModel

    def warmup(self, ctx) -> None:
        pass

    def triage(self, req, now, ctx) -> TriageResult:
        lat = self.oracle.proxy_latency
        return TriageResult(
            L=float(self.oracle.entropy[req.rid]),
            proxy_output=int(self.oracle.proxy_pred[req.rid]),
            cost_s=lat.step_time(1) if lat is not None else 0.0)

    def step(self, now, ctx) -> list[Completion]:
        return []

    # -- fault surface (repro_torch.faults) -----------------------------------
    def cancel_queued(self, pred=None) -> list:
        """Remove queued (not yet started) requests; engines without a
        cancellable queue strand nothing."""
        return []

    def on_crash(self, now: float) -> None:
        """Forget all committed virtual-time work (the crash clawed the
        corresponding responses back); a revived node starts cold."""
        return None

    def set_latency(self, latency: LatencyModel) -> None:
        """Swap the service model in place — slow-node degradation
        installs a scaled COPY here (the default models are shared
        across replicas and must never be mutated)."""
        self.latency = latency


@dataclass
class SimDirectEngine(_SimEngineBase):
    """Serial per-request execution (FastAPI+ORT analogue) over the
    real ``DirectPath`` scheduler.

    No queue — arrivals serialise behind the path's ``ServiceLine`` —
    so the congestion signal is the backlog *time*, not a queue depth.
    ``load()`` converts that backlog into an equivalent queue depth at
    the last observed clock so the admission controller's C(x) leg
    still sees saturation.
    """
    _core: DirectPath = field(init=False, repr=False)
    _now: float = field(default=0.0, init=False)

    def __post_init__(self):
        self._core = DirectPath(self.latency)

    def warmup(self, ctx) -> None:
        self._core.reset()
        self._now = 0.0

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="sim-direct", kind="classify",
                                  paths=(PATH_DIRECT,))

    def pressure(self, now: float) -> float:
        return self._core.backlog(now)

    def load(self) -> LoadState:
        step = max(self.latency.step_time(1), 1e-9)
        return LoadState(queue_depth=int(self.pressure(self._now)
                                         / step))

    def step(self, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        return []

    def submit(self, req, path, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        b = self._core.serve(req, now)
        return [Completion([req],
                           [int(self.oracle.full_pred[req.rid])],
                           PATH_DIRECT, b.t_start, b.t_finish)]

    def drain(self, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        return []

    def on_crash(self, now: float) -> None:
        self._core.reset()

    def set_latency(self, latency: LatencyModel) -> None:
        self.latency = latency
        self._core.latency = latency


@dataclass
class SimBatchEngine(_SimEngineBase):
    """Managed dynamic batching (Triton analogue) over the real
    ``DynamicBatcher``: the fused batch pays one fixed orchestration
    cost plus per-item marginal compute, and timeout flushes round
    down to Triton-style ``preferred_sizes`` (default: powers of two
    up to ``max_batch``; pass ``()`` to disable)."""
    max_batch: int = 32
    queue_window_s: float = 0.02
    preferred_sizes: tuple | None = None

    _core: DynamicBatcher = field(init=False, repr=False)

    def __post_init__(self):
        if self.preferred_sizes is None:
            self.preferred_sizes = tuple(
                p for p in (4, 8, 16, 32, 64, 128)
                if p <= self.max_batch)
        self._core = DynamicBatcher(self.latency,
                                    max_batch_size=self.max_batch,
                                    queue_window_s=self.queue_window_s,
                                    preferred_sizes=self.preferred_sizes)

    def warmup(self, ctx) -> None:
        self._core.reset()

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="sim-batch", kind="classify",
                                  paths=(PATH_DYNAMIC_BATCH,))

    def pressure(self, now: float) -> float:
        return self._core.backlog(now)

    def load(self) -> LoadState:
        return LoadState(queue_depth=self._core.queue_depth,
                         batch_fill=self._core.fill)

    def _completion(self, b) -> Completion:
        return Completion(
            b.requests,
            [int(self.oracle.full_pred[r.rid]) for r in b.requests],
            PATH_DYNAMIC_BATCH, b.t_start, b.t_finish)

    def submit(self, req, path, now, ctx) -> list[Completion]:
        return [self._completion(b) for b in self._core.submit(req, now)]

    def step(self, now, ctx) -> list[Completion]:
        return [self._completion(b) for b in self._core.poll(now)]

    def drain(self, now, ctx) -> list[Completion]:
        return [self._completion(b) for b in self._core.drain(now)]

    def cancel_queued(self, pred=None) -> list:
        return self._core.cancel(pred)

    def on_crash(self, now: float) -> None:
        self._core.reset()

    def set_latency(self, latency: LatencyModel) -> None:
        self.latency = latency
        self._core.latency = latency


@dataclass
class SimGatedEngine(_SimEngineBase):
    """In-graph admission (the gated step on the device, virtual time).

    Queues through the shared ``BatchQueue`` window/size policy and
    serialises on a ``ServiceLine`` — the same cores ``DynamicBatcher``
    is built from (no preferred-size rounding: the gate prices per
    admitted request, not per batch shape).  Each formed batch reads
    the controller snapshot ``(tau, e_norm, c_norm)`` through
    ``ctx.snapshot`` and gates per request with the SAME
    ``gate_objective``/``gate_admit`` math the
    ``make_gated_classify_step`` fuses on device.  Only admitted
    requests pay marginal compute (skips are answered by the proxy
    prediction), so the batch walltime — and the joules the admission
    middleware feeds back into the EWMA — shrinks with the skip rate.
    """
    max_batch: int = 16
    queue_window_s: float = 0.02
    l_scale: float = float(np.log(2.0))     # binary-entropy normaliser
    rule: str = "le"                        # mirror GateParams.rule

    _window: BatchQueue = field(init=False, repr=False)
    _line: ServiceLine = field(init=False, repr=False)
    _gate: GateParams = field(init=False, repr=False)

    def __post_init__(self):
        self._window = BatchQueue(max_batch_size=self.max_batch,
                                  queue_window_s=self.queue_window_s)
        self._line = ServiceLine()
        self._gate = GateParams(rule=self.rule)

    def warmup(self, ctx) -> None:
        self._window.reset()
        self._line.reset()

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="sim-gated", kind="classify",
                                  paths=(PATH_GATED,),
                                  in_graph_admission=True)

    def triage(self, req, now, ctx) -> TriageResult:
        return TriageResult(L=None)        # the gate runs in-graph

    def pressure(self, now: float) -> float:
        backlog = self._line.backlog(now)
        if self._window.queue:
            backlog += self.latency.step_time(len(self._window.queue))
        return backlog

    def load(self) -> LoadState:
        return LoadState(queue_depth=self._window.queue_depth,
                         batch_fill=self._window.fill)

    def submit(self, req, path, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx)
                for b in self._window.submit(req, now)]

    def step(self, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx) for b in self._window.poll(now)]

    def drain(self, now, ctx) -> list[Completion]:
        return [self._execute(b, ctx) for b in self._window.drain(now)]

    def _execute(self, b, ctx) -> Completion:
        reqs, t = b.requests, b.t_formed
        tau, e_norm, c_norm = ctx.snapshot(t)
        ent = np.array([float(self.oracle.entropy[r.rid]) for r in reqs])
        l_n = np.clip(ent / max(self.l_scale, 1e-9), 0.0, 1.0)
        J = gate_objective(l_n, e_norm, c_norm, self._gate)
        admit = gate_admit(J, tau, self._gate.rule)
        n_admit = int(admit.sum())
        outputs = [int(self.oracle.full_pred[r.rid]) if a
                   else int(self.oracle.proxy_pred[r.rid])
                   for r, a in zip(reqs, admit)]
        # fixed cost covers the in-graph proxy pass over the whole
        # batch; only the admitted bucket pays full-model compute
        start, finish = self._line.reserve(
            t, self.latency.t_fixed_s + n_admit * self.latency.t_tok_s)
        return Completion(
            requests=reqs, outputs=outputs, path=PATH_GATED,
            t_start=start, t_finish=finish,
            admit_mask=[bool(a) for a in admit],
            extras={"tau": float(tau), "e_norm": float(e_norm),
                    "c_norm": float(c_norm)},
            per_request=[{"entropy": float(e)} for e in ent])

    def cancel_queued(self, pred=None) -> list:
        return self._window.cancel(pred)

    def on_crash(self, now: float) -> None:
        self._window.reset()
        self._line.reset()


@dataclass
class SimContinuousEngine(_SimEngineBase):
    """Slot-pool decode (vLLM-style continuous batching, virtual time)
    over the ``SlotClock`` core extracted from ``serving.continuous``.

    ``n_slots`` requests run concurrently; each pays a startup fixed
    cost plus ``service_tokens`` marginal steps.  Busy time sums over
    slots — the modelled analogue of a decode pool keeping the chip
    hot — so its energy character is 'cheap marginal, always-warm'.
    """
    n_slots: int = 8
    service_tokens: int = 16

    _slots: SlotClock = field(init=False, repr=False)
    _now: float = field(default=0.0, init=False)

    def __post_init__(self):
        self._slots = SlotClock(self.n_slots)

    def warmup(self, ctx) -> None:
        self._slots.reset()
        self._now = 0.0

    def capabilities(self) -> EngineCapabilities:
        return EngineCapabilities(name="sim-continuous", kind="classify",
                                  paths=(PATH_CONTINUOUS,))

    def pressure(self, now: float) -> float:
        return self._slots.pressure(now)

    def load(self) -> LoadState:
        # occupancy at the last observed clock: slots still serving
        busy = self._slots.busy(self._now)
        return LoadState(queue_depth=busy,
                         batch_fill=busy / max(self.n_slots, 1))

    def step(self, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        return []

    def submit(self, req, path, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        slot, start, finish = self._slots.reserve(
            now, self.latency.t_fixed_s
            + self.service_tokens * self.latency.t_tok_s)
        return [Completion([req],
                           [int(self.oracle.full_pred[req.rid])],
                           PATH_CONTINUOUS, start, finish,
                           extras={"slot": slot})]

    def drain(self, now, ctx) -> list[Completion]:
        self._now = max(self._now, now)
        return []

    def on_crash(self, now: float) -> None:
        self._slots.reset()


# ---------------------------------------------------------------------------
# the replica
# ---------------------------------------------------------------------------

@dataclass
class Replica:
    """One fleet serving node: a full ``Server`` (engine + controller
    middleware) plus the lifecycle / energy state the router and
    autoscaler operate on."""
    name: str
    kind: str                              # one of REPLICA_KINDS
    server: Server
    controller: AdmissionController | None = None
    utility: float = 1.0                   # expected-quality prior
    energy_prior_j: float = 1.0            # joules/request before data
    energy_model: EnergyModel = field(default_factory=EnergyModel)

    state: str = field(default=ACTIVE, init=False)
    n_routed: int = field(default=0, init=False)
    active_s: float = field(default=0.0, init=False)   # powered-on time
    health: HealthState = field(default_factory=HealthState, init=False)
    pressure_bias_s: float = field(default=0.0, init=False)  # kv-spike
    wasted_j: float = field(default=0.0, init=False)   # crash-burned J
    _base_latency: LatencyModel | None = field(default=None, init=False,
                                               repr=False)

    # -- serving ------------------------------------------------------------
    def start(self) -> "Replica":
        """Open a fresh serving run: resets the wrapped server AND the
        per-run fleet state (powered-on time, routed count, lifecycle),
        so a pool can be re-run."""
        self.server.start()
        self.state = ACTIVE
        self.n_routed = 0
        self.active_s = 0.0
        self.health.reset()
        self.pressure_bias_s = 0.0
        self.wasted_j = 0.0
        if self._base_latency is not None:
            self._set_engine_latency(self._base_latency)
            self._base_latency = None
        return self

    def push(self, req) -> list:
        self.n_routed += 1
        return self.server.push(req)

    def poke(self, now: float) -> list:
        return self.server.poke(now)

    def finish(self, now: float) -> list:
        return self.server.finish(now)

    # -- lifecycle (autoscaler) ---------------------------------------------
    def drain(self, now: float) -> list:
        """Flush queued work and power down (stops idle burn; the
        request-path ``EnginePort.drain`` does the flushing).  The
        node stays powered through the flush, so powered-on time
        extends to the last drained completion — otherwise the flush's
        busy seconds would eat pre-drain idle time in energy_j()."""
        out = self.server.drain_now(now)
        tail = max((r.t_finish for r in out), default=now)
        self.active_s += max(tail - now, 0.0)
        self.state = STOPPED
        return out

    def revive(self) -> None:
        self.state = ACTIVE

    @property
    def routable(self) -> bool:
        return self.state == ACTIVE and self.health.routable

    @property
    def revivable(self) -> bool:
        """What the autoscaler may wake: parked capacity, not crashed
        capacity.  A FAILED node only comes back through its scheduled
        :meth:`recover`."""
        return self.state == STOPPED and self.health.status != FAILED

    # -- faults (repro_torch.faults) ----------------------------------------
    def crash(self, now: float, duration_s: float = 0.5):
        """The node dies: queued work is stranded, in-flight work lost,
        partially-burned joules wasted (see ``Server.crash_now``).
        Returns the :class:`~repro_torch.serving.api.CrashReport`; the fleet
        loop decides retry vs reject for everything in it."""
        report = self.server.crash_now(now)
        self.state = STOPPED
        self.health.fail(now, duration_s)
        self.wasted_j += report.wasted_j
        return report

    def degrade(self, now: float, factor: float,
                duration_s: float) -> None:
        """Slow node: service times multiplied by ``factor`` until the
        episode ends (installed as a scaled COPY of the base latency
        model — the defaults are shared across replicas)."""
        self.health.degrade(now, factor, duration_s)
        base = getattr(self.server.engine, "latency", None)
        if base is None:
            return                       # live adapters: no sim model
        if self._base_latency is None:
            self._base_latency = base
        b, s = self._base_latency, self.health.slow_factor
        self._set_engine_latency(LatencyModel(t_fixed_s=b.t_fixed_s * s,
                                              t_tok_s=b.t_tok_s * s))

    def kv_spike(self, now: float, bias_s: float,
                 duration_s: float) -> None:
        """KV-pool exhaustion: the node looks congested (pressure bias)
        without being slower per request."""
        self.health.degrade(now, 1.0, duration_s)
        self.pressure_bias_s = max(self.pressure_bias_s, float(bias_s))

    def recover(self, now: float, recovering_s: float = 0.0) -> None:
        """End the current health episode: restore the base service
        model, clear the pressure bias, re-enter service (through
        RECOVERING when ``recovering_s > 0``)."""
        self.health.recover(now, recovering_s)
        self.pressure_bias_s = 0.0
        if self._base_latency is not None:
            self._set_engine_latency(self._base_latency)
            self._base_latency = None
        if self.state == STOPPED:
            self.revive()

    def _set_engine_latency(self, latency: LatencyModel) -> None:
        set_lat = getattr(self.server.engine, "set_latency", None)
        if callable(set_lat):
            set_lat(latency)

    # -- signals ------------------------------------------------------------
    def load(self) -> LoadState:
        return self.server.engine.load()

    def pressure(self, now: float) -> float:
        """Seconds of backlog/queued work at ``now`` — the uniform
        ``EnginePort.pressure`` signal (``LoadState``-derived default
        for engines that predate the protocol extension), plus any
        KV-spike congestion bias."""
        return self.server.pressure(now) + self.pressure_bias_s

    def joules_per_request(self) -> float:
        """Marginal-energy signal: the controller's EnergyMeter EWMA,
        or the analytic prior before any traffic has been metered."""
        if (self.controller is not None
                and self.controller.meter.joules_per_request > 0):
            return self.controller.meter.joules_per_request
        return self.energy_prior_j

    @property
    def busy_s(self) -> float:
        ctx = getattr(self.server, "ctx", None)
        return ctx.busy_s if ctx is not None else self.server.busy_s

    def energy_j(self) -> float:
        """Modelled node energy: active power over busy time + idle
        power over the remaining powered-on time."""
        busy = self.busy_s
        idle = max(self.active_s - busy, 0.0)
        return (self.energy_model.p_active * busy
                + self.energy_model.p_idle * idle)

    def report(self) -> dict:
        n = self.server.log.n
        return {
            "name": self.name,
            "kind": self.kind,
            "state": self.state,
            "health": self.health.status,
            "n_crashes": self.health.n_crashes,
            "wasted_j": round(self.wasted_j, 4),
            "n_routed": self.n_routed,
            "n_served": n,
            "busy_s": round(self.busy_s, 4),
            "active_s": round(self.active_s, 4),
            "energy_j": round(self.energy_j(), 3),
            "joules_per_request": round(
                self.energy_j() / max(n, 1), 4),
            "ewma_j_per_req": round(self.joules_per_request(), 4),
            "admission_rate": (round(
                self.controller.admission_rate, 4)
                if self.controller is not None else 1.0),
        }


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

_DEFAULT_LATENCY = {
    PATH_DIRECT: LatencyModel(t_fixed_s=0.002, t_tok_s=0.004),
    PATH_DYNAMIC_BATCH: LatencyModel(t_fixed_s=0.020, t_tok_s=0.0015),
    PATH_GATED: LatencyModel(t_fixed_s=0.016, t_tok_s=0.0020),
    PATH_CONTINUOUS: LatencyModel(t_fixed_s=0.004, t_tok_s=0.0004),
}


def make_sim_replica(name: str, kind: str, oracle: Oracle, *,
                     controller: AdmissionController | None = None,
                     latency: LatencyModel | None = None,
                     max_batch: int = 32, queue_window_s: float = 0.02,
                     n_slots: int = 8,
                     energy_model: EnergyModel | None = None) -> Replica:
    """Build a virtual-time replica of the given execution-path kind.

    ``controller=None`` serves open-loop but still plugs in a disabled
    ``AdmissionController`` so the per-replica EnergyMeter EWMA — the
    router's marginal-energy signal — is always fed.
    """
    if kind not in REPLICA_KINDS:
        raise ValueError(f"unknown replica kind {kind!r}; expected one "
                         f"of {REPLICA_KINDS}")
    em = energy_model or EnergyModel()
    lat = latency or _DEFAULT_LATENCY[kind]
    if controller is None:
        controller = AdmissionController(enabled=False, log_history=False)

    if kind == PATH_DIRECT:
        engine = SimDirectEngine(oracle, lat)
        prior = em.p_active * lat.step_time(1)
    elif kind == PATH_DYNAMIC_BATCH:
        engine = SimBatchEngine(oracle, lat, max_batch=max_batch,
                                queue_window_s=queue_window_s)
        # prior at half fill: optimistic enough to be reachable, honest
        # about the orchestration overhead at low load
        half = max(max_batch // 2, 1)
        prior = em.p_active * lat.step_time(half) / half
    elif kind == PATH_GATED:
        engine = SimGatedEngine(oracle, lat,
                                max_batch=max(max_batch // 2, 1),
                                queue_window_s=queue_window_s,
                                rule=controller.rule)
        half = max(max_batch // 4, 1)
        prior = em.p_active * lat.step_time(half) / half
    else:
        engine = SimContinuousEngine(oracle, lat, n_slots=n_slots)
        prior = em.p_active * (lat.t_fixed_s + 16 * lat.t_tok_s)

    server = Server(engine,
                    ServerConfig(path=kind, energy_model=em),
                    middleware=[AdmissionMiddleware(controller)])
    return Replica(name=name, kind=kind, server=server,
                   controller=controller, energy_prior_j=prior,
                   energy_model=em)
