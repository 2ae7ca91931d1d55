"""The replica pool and the event-driven fleet simulator.

:class:`ReplicaPool` owns N heterogeneous replicas and the fleet-level
signals the autoscaler reads (total energy including idle burn,
requests served); :class:`FleetSimulator` drives a workload trace
through the fleet on one virtual clock:

    for each arrival (time order):
        advance powered-on time on every non-stopped replica
        poke all replicas (flush expired batch windows)
        autoscaler.observe(...)          # maybe drain / revive
        replica = router.route(request)  # the live ORT-vs-Triton call
        replica.push(request)            # full per-replica Server
                                         # lifecycle: triage ->
                                         # admission -> execute
    finish: drain every replica, close per-replica Servers

Energy is node-accounted: each replica burns active power over its
busy time and idle power over the rest of its powered-on time, which
is exactly why the autoscaler's draining saves joules at the fleet
level.  Totals flow into a fleet :class:`CarbonTracker`
(region/intensity-configurable — nodes may sit in different grids).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleet.autoscaler import Autoscaler
from repro_torch.fleet.replica import (REPLICA_KINDS, STOPPED, Replica,
                                       make_sim_replica)
from repro_torch.fleet.router import EnergyAwareRouter, Router
from repro_torch.serving.api import (PATH_DIRECT, PATH_DYNAMIC_BATCH,
                                     PATH_GATED, PATH_GENERATE,
                                     AdmissionMiddleware, Server,
                                     ServerConfig)
from repro_torch.serving.simulator import Oracle
from repro_torch.telemetry.carbon import CarbonTracker

# live replicas serve the classifier paths plus the split-phase
# generate kind (disaggregated prefill/decode behind one EnginePort);
# per-request `kind` routing keeps the workloads on matching nodes.
# The classifier trio is the default fleet shape — the generate kind
# needs LM weights, so it only joins a pool when asked for by name.
LIVE_CLASSIFIER_KINDS = (PATH_DIRECT, PATH_DYNAMIC_BATCH, PATH_GATED)
LIVE_REPLICA_KINDS = LIVE_CLASSIFIER_KINDS + (PATH_GENERATE,)


def _unknown_kind_msg(kind: str, valid) -> str:
    """Unknown-kind error with the nearest valid alternative, so a
    typo'd ``--fleet-kinds dynamic-batsh`` tells you what you meant
    instead of only what exists."""
    import difflib
    msg = (f"unknown live replica kind {kind!r}; "
           f"expected one of {valid}")
    close = difflib.get_close_matches(kind, valid, n=1, cutoff=0.4)
    if close:
        msg += f" — did you mean {close[0]!r}?"
    return msg


@dataclass
class ReplicaPool:
    replicas: list[Replica]

    def __post_init__(self):
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")

    def __iter__(self):
        return iter(self.replicas)

    def __len__(self):
        return len(self.replicas)

    def by_name(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        import difflib
        names = [r.name for r in self.replicas]
        msg = f"unknown replica {name!r}; pool has {names}"
        close = difflib.get_close_matches(name, names, n=1, cutoff=0.4)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        raise KeyError(msg)

    def routable(self) -> list[Replica]:
        return [r for r in self.replicas if r.routable]

    def routable_for(self, req) -> list[Replica]:
        """Routable replicas whose workload matches the request:
        generate-kind requests land only on generate nodes, classify
        requests only on classifier nodes.  A request with no matching
        node is retried/rejected-with-reason by the fleet loop (bare
        ``Router.route`` still raises its clear no-replicas error)
        rather than decoding garbage on the wrong backend."""
        want_gen = getattr(req, "kind", "classify") == "generate"
        match = [r for r in self.routable()
                 if (r.kind == PATH_GENERATE) == want_gen]
        return match

    def start(self) -> "ReplicaPool":
        for r in self.replicas:
            r.start()
        return self

    def tick(self, dt: float) -> None:
        """Accumulate powered-on time on every non-stopped replica."""
        if dt <= 0:
            return
        for r in self.replicas:
            if r.state != STOPPED:
                r.active_s += dt

    def drain(self, replica: Replica, now: float) -> list:
        return replica.drain(now)

    def revive(self, replica: Replica) -> None:
        replica.revive()

    # -- fleet-level signals -------------------------------------------------
    def energy_j(self) -> float:
        """Fleet energy as of the last tick/busy update."""
        return sum(r.energy_j() for r in self.replicas)

    def n_served(self) -> int:
        return sum(r.server.log.n for r in self.replicas)


def build_sim_fleet(oracle: Oracle, kinds=REPLICA_KINDS[:3], *,
                    controller_factory=None, max_batch: int = 32,
                    queue_window_s: float = 0.02,
                    n_slots: int = 8,
                    energy_model=None) -> ReplicaPool:
    """A heterogeneous virtual-time fleet, one replica per kind (kinds
    may repeat: ``("direct", "direct", "dynamic-batch")`` builds two
    direct nodes).  ``controller_factory(kind, i) -> controller`` gives
    each replica its own closed-loop controller; default is open-loop
    (disabled) controllers, which still feed the EnergyMeter EWMAs the
    router needs."""
    replicas = []
    for i, kind in enumerate(kinds):
        ctrl = (controller_factory(kind, i)
                if controller_factory is not None else None)
        replicas.append(make_sim_replica(
            f"{kind}-{i}", kind, oracle, controller=ctrl,
            max_batch=max_batch, queue_window_s=queue_window_s,
            n_slots=n_slots, energy_model=energy_model))
    return ReplicaPool(replicas)


def make_live_replica(name: str, kind: str, cfg: dict, params, *,
                      engine=None, controller=None, max_batch: int = 8,
                      queue_window_s: float = 0.02, exit_layer: int = 1,
                      energy_prior_j: float = 1.0,
                      energy_model=None, n_slots: int = 4,
                      max_seq: int = 64,
                      prompt_len: int | None = None,
                      device="cuda") -> Replica:
    """One fleet node over a LIVE execution backend (the real model on
    ``device``, the card by default; measured walltimes) — same
    ``Replica`` surface as the virtual-time nodes, so routers,
    autoscalers and scenarios cannot tell them apart.

    ``engine`` (a ``ClassifierEngine``) may be shared across the
    classifier-backed replicas of a pool: a call keeps no state between
    calls, and each adapter keeps its own queue and free-at horizon
    (its own node clock).  The gated kind builds its own fused step.
    Every classify kind computes the proxy entropy L(x) through
    ``kernels.ops.entropy_stats``: the CUDA entropy kernel on the card.

    ``energy_model`` defaults to ``EnergyModel()``; the launcher passes
    the card's constant set.  The ``generate`` kind (the split-phase
    disaggregated engine) is listed, as in the reference, but raises
    ``NotImplementedError`` until disaggregation is ported.
    """
    from repro_torch.core.controller import AdmissionController
    from repro_torch.core.energy import EnergyModel
    from repro_torch.serving.adapters import (ClassifierEngineAdapter,
                                              GatedEngineAdapter)
    from repro_torch.serving.engine import ClassifierEngine

    if kind not in LIVE_REPLICA_KINDS:
        raise ValueError(_unknown_kind_msg(kind, LIVE_REPLICA_KINDS))
    if kind == PATH_GENERATE:
        raise NotImplementedError(
            "the live generate replica wraps the disaggregated "
            "prefill/decode engine, which is not ported yet (ROADMAP "
            "item 10)")
    em = energy_model or EnergyModel()
    if controller is None:
        controller = AdmissionController(enabled=False,
                                         log_history=False)

    if kind == PATH_GATED:
        port = GatedEngineAdapter(cfg, params, batch=max_batch,
                                  exit_layer=exit_layer,
                                  queue_window_s=queue_window_s,
                                  device=device)
    else:
        if engine is None:
            engine = ClassifierEngine(cfg, params,
                                      exit_layer=exit_layer,
                                      device=device)
        port = ClassifierEngineAdapter(
            engine, max_batch=max_batch,
            queue_window_s=(queue_window_s
                            if kind == PATH_DYNAMIC_BATCH else 0.0))
    server = Server(port, ServerConfig(path=kind, energy_model=em),
                    middleware=[AdmissionMiddleware(controller)])
    return Replica(name=name, kind=kind, server=server,
                   controller=controller,
                   energy_prior_j=energy_prior_j, energy_model=em)


def build_live_fleet(cfg: dict, params,
                     kinds=LIVE_CLASSIFIER_KINDS, *,
                     controller_factory=None, max_batch: int = 8,
                     queue_window_s: float = 0.02, exit_layer: int = 1,
                     seq_len: int = 32, calibrate: bool = True,
                     engine=None, energy_model=None,
                     device="cuda") -> ReplicaPool:
    """The live-engine fleet: a small heterogeneous pool over the real
    ``ClassifierEngineAdapter``/``GatedEngineAdapter`` backends on
    ``device`` (the card by default; measured walltimes advance the
    virtual clock), driven by the same ``FleetSimulator``/scenario
    suite as the sim fleet.

    One ``ClassifierEngine`` is shared by the classifier-backed
    replicas; pass ``engine`` to share it across POOLS too.  With
    ``calibrate`` the router's cold-start energy priors come from
    measured per-bucket step times instead of a flat guess — the same
    honest-at-half-fill shape ``make_sim_replica`` uses.  The replicas
    share one card and the fleet steps them one at a time, each batch
    synchronized, so one replica's walltime never holds another's work.
    """
    from repro_torch.core.energy import EnergyModel
    from repro_torch.serving.engine import ClassifierEngine

    for k in kinds:
        if k not in LIVE_REPLICA_KINDS:
            raise ValueError(_unknown_kind_msg(k, LIVE_REPLICA_KINDS))
    em = energy_model or EnergyModel()
    # the shared classifier engine backs only the direct/dynamic-batch
    # replicas (the gated kind builds its own fused step) — don't build
    # or calibrate it for a pool with neither
    if engine is None and set(kinds) - {PATH_GATED, PATH_GENERATE}:
        engine = ClassifierEngine(cfg, params, exit_layer=exit_layer,
                                  device=device)
    priors = {k: 1.0 for k in LIVE_REPLICA_KINDS}
    if calibrate and engine is not None:
        half = max(max_batch // 2, 1)
        times = engine.calibrate(seq_len=seq_len,
                                 buckets=(1, half, max_batch))
        priors[PATH_DIRECT] = em.p_active * times[1]
        priors[PATH_DYNAMIC_BATCH] = em.p_active * times[half] / half
        # only the gate's capacity bucket (default B//2) pays
        # full-model compute; the in-graph proxy pass rides in the
        # same fused step, so per request the gate starts ~half the
        # dynamic-batch cost until its own EWMA takes over
        priors[PATH_GATED] = em.p_active * times[half] / half / 2

    replicas = []
    for i, kind in enumerate(kinds):
        ctrl = (controller_factory(kind, i)
                if controller_factory is not None else None)
        replicas.append(make_live_replica(
            f"{kind}-{i}", kind, cfg, params,
            engine=(None if kind == PATH_GENERATE else engine),
            controller=ctrl, max_batch=max_batch,
            queue_window_s=queue_window_s, exit_layer=exit_layer,
            energy_prior_j=priors[kind], energy_model=em,
            device=device))
    return ReplicaPool(replicas)


@dataclass
class FleetReport:
    responses: list
    per_replica: list[dict]
    summary: dict
    carbon: dict
    autoscaler_log: list = field(default_factory=list)

    def __str__(self):
        import json
        return json.dumps({"summary": self.summary,
                           "per_replica": self.per_replica,
                           "carbon": self.carbon}, indent=2)


@dataclass
class FleetSimulator:
    """Drives one workload trace through the pool per ``run()`` call.

    ``run()`` is re-runnable — ``pool.start()`` resets per-run replica
    state — but the fleet ``carbon`` meter is a *tracker*: it
    accumulates every run's joules into one cumulative CO2 record,
    exactly like :class:`CarbonTracker` windows elsewhere.
    """
    pool: ReplicaPool
    router: Router = field(default_factory=EnergyAwareRouter)
    autoscaler: Autoscaler | None = None
    carbon: CarbonTracker = field(default_factory=CarbonTracker)
    scale_every: int = 20          # autoscaler cadence, in arrivals
    tracer: object = None          # telemetry.trace recorder; None=off
    metrics: object = None         # telemetry.metrics registry; None=off
    # -- failure model (repro_torch.faults) --------------------------------
    injector: object = None        # faults.FaultInjector; None = no faults
    retry_policy: object = None    # faults.RetryPolicy; None = default
    brownout: object = None        # faults.BrownoutController; None = off
    recovering_s: float = 0.25     # warm-up interlude after a crash window

    def _export_gauges(self, metrics, now: float) -> None:
        """Per-replica gauges each scale tick: pressure, queue depth,
        EnergyMeter EWMA, τ(t) via the side-effect-free ``peek``, and
        admission rate (open-loop replicas read τ=+Inf, rate 1.0)."""
        for r in self.pool.replicas:
            lab = {"replica": r.name, "kind": r.kind}
            metrics.gauge("fleet_pressure",
                          "backlog seconds per replica").set(
                r.pressure(now), **lab)
            metrics.gauge("fleet_queue_depth",
                          "requests queued per replica").set(
                r.load().queue_depth, **lab)
            metrics.gauge("fleet_joules_per_request",
                          "EnergyMeter EWMA (or prior)").set(
                r.joules_per_request(), **lab)
            ctl = r.controller
            tau, admit = float("inf"), 1.0
            if ctl is not None:
                tau = ctl.peek(now)[0]
                rate = ctl.admission_rate
                admit = rate if rate == rate else 1.0   # NaN pre-traffic
            metrics.gauge("fleet_tau",
                          "admission threshold τ(t)").set(tau, **lab)
            metrics.gauge("fleet_admission_rate",
                          "fraction admitted").set(admit, **lab)
            sess = getattr(r.server.engine, "_session", None)
            if (sess is not None
                    and getattr(sess.engine, "draft_depth", 0) > 0):
                st = sess.stats()
                metrics.gauge("decode_acceptance_rate",
                              "speculative draft acceptance rate").set(
                    float(st.get("acceptance_rate", 0.0)), **lab)
                metrics.gauge("decode_draft_depth",
                              "live speculative draft depth").set(
                    float(st.get("draft_depth_live", 0)), **lab)
        metrics.gauge("fleet_energy_j", "fleet modelled joules").set(
            self.pool.energy_j())
        if self.brownout is not None:
            metrics.gauge("fleet_brownout_scale",
                          "τ brownout multiplier (1 = no pressure)").set(
                self.brownout.scale(now))

    # -- failure-path internals ---------------------------------------------
    def _mint_reject(self, req, now: float, reason: str):
        from repro_torch.serving.api import PATH_REJECT, InferResponse
        return InferResponse(
            rid=req.rid, output=None, admitted=False, path=PATH_REJECT,
            arrival_s=float(req.arrival_s), t_start=now, t_finish=now,
            label=getattr(req, "label", None),
            telemetry={"reason": reason})

    def _resolve_target(self, target: str):
        """A fault's target replica; an empty target hits the first
        active node (deterministic pool order)."""
        if target:
            return self.pool.by_name(target)
        for r in self.pool.replicas:
            if r.state != STOPPED:
                return r
        return None

    def run(self, requests) -> FleetReport:
        import heapq
        import itertools
        from dataclasses import replace as dc_replace

        from repro_torch.faults.retry import RetryPolicy
        from repro_torch.serving.api import request_expiry
        from repro_torch.telemetry.metrics import NULL_METRICS
        from repro_torch.telemetry.trace import NULL_TRACER

        requests = sorted(requests, key=lambda r: r.arrival_s)
        tracer = self.tracer if self.tracer is not None else NULL_TRACER
        metrics = (self.metrics if self.metrics is not None
                   else NULL_METRICS)
        if tracer.enabled or metrics.enabled:
            # thread the recorders into every replica's Server (the
            # replica name prefixes its resource tracks) BEFORE
            # start() binds them into the server context
            for r in self.pool.replicas:
                r.server.tracer = self.tracer
                r.server.metrics = self.metrics
                r.server.name = r.name
            if getattr(self.router, "tracer", "no") is None:
                self.router.tracer = self.tracer
        self.pool.start()
        if self.injector is not None:
            self.injector.reset()
        retry = self.retry_policy or RetryPolicy()
        brown = self.brownout
        if brown is not None:
            brown.reset()

        # one merged virtual-time event heap: arrivals (originals and
        # retries), scheduled faults, and scheduled recoveries.  The
        # loop runs until the heap drains, so late retries and
        # recoveries keep the clock advancing past the last arrival.
        seq = itertools.count()
        heap: list = []
        for req in requests:
            heapq.heappush(heap, (float(req.arrival_s), next(seq),
                                  "arrival", req))
        if self.injector is not None:
            for ev in self.injector.plan.events:
                heapq.heappush(heap, (float(ev.t), next(seq),
                                      "fault", ev))

        first = heap[0][0] if heap else 0.0
        prev = first
        n_arrivals = 0
        attempts: dict[int, int] = {}      # rid -> retries used
        orig_arrival: dict[int, float] = {}
        by_rid: dict[int, object] = {}     # rid -> latest request copy
        fleet_out: list = []               # fleet-minted rejections
        stats = {"n_retries": 0, "n_failures": 0, "n_expired": 0,
                 "n_rejected_fleet": 0}
        link_down_until = -float("inf")

        def pressure_event(weight: float, now: float) -> None:
            if brown is None:
                return
            brown.record(now, weight)
            s = brown.scale(now)
            for r in self.pool.replicas:
                if r.controller is not None:
                    r.controller.tau_scale = s

        def requeue(req, now: float, reason: str,
                    not_before: float = 0.0) -> None:
            """Bounded retry with exponential backoff, else terminate
            as a rejection-with-reason (never a hang)."""
            attempt = attempts.get(req.rid, 0) + 1
            if retry.allows(attempt):
                attempts[req.rid] = attempt
                orig_arrival.setdefault(req.rid, float(req.arrival_s))
                meta = getattr(req, "metadata", None)
                if (meta is not None and "expires_at" not in meta
                        and getattr(req, "deadline_s", None) is not None):
                    # pin the ABSOLUTE deadline before arrival_s moves
                    meta["expires_at"] = request_expiry(req)
                t_retry = max(now, not_before) + retry.delay(attempt)
                copy = dc_replace(req, arrival_s=t_retry)
                by_rid[req.rid] = copy
                heapq.heappush(heap, (t_retry, next(seq),
                                      "arrival", copy))
                stats["n_retries"] += 1
                metrics.counter("fleet_retries",
                                "requeued requests, by reason").inc(
                    reason=reason)
                tracer.event("retry", now, resource="faults",
                             rid=req.rid, attempt=attempt,
                             reason=reason, at=t_retry)
                pressure_event(0.25, now)
            else:
                reject(req, now, f"retry-budget:{reason}")

        def reject(req, now: float, reason: str) -> None:
            fleet_out.append(self._mint_reject(req, now, reason))
            stats["n_rejected_fleet"] += 1
            if reason == "deadline-expired":
                stats["n_expired"] += 1
                metrics.counter("fleet_expired",
                                "requests shed past deadline").inc()
                pressure_event(0.25, now)
            tracer.event("reject", now, resource="faults",
                         rid=req.rid, reason=reason)

        def apply_fault(ev, now: float) -> None:
            stats["n_failures"] += 1
            metrics.counter("fleet_failures",
                            "injected faults, by kind").inc(
                kind=ev.kind, target=ev.target or "auto")
            pressure_event(1.0, now)
            if ev.kind == "link-flap":
                # the fleet's ingress link: arrivals during the outage
                # are lost in transit and retried after it lifts
                nonlocal link_down_until
                link_down_until = max(link_down_until,
                                      now + ev.duration_s)
                tracer.event("fault", now, resource="faults",
                             kind=ev.kind, until=link_down_until)
                return
            r = self._resolve_target(ev.target)
            if r is None:
                return
            if ev.kind == "crash":
                report = (r.crash(now, ev.duration_s)
                          if r.state != STOPPED
                          else r.health.fail(now, ev.duration_s))
                tracer.event("fault", now, resource="faults",
                             kind=ev.kind, replica=r.name,
                             n_lost=(report.n_lost if report else 0))
                if report:
                    metrics.counter(
                        "fleet_wasted_j",
                        "joules burned on work lost to crashes").inc(
                        report.wasted_j, replica=r.name)
                    stranded = list(report.stranded)
                    stranded += [by_rid[rid] for rid in report.lost_rids
                                 if rid in by_rid]
                    for sr in stranded:
                        requeue(sr, now, "replica-crash")
                heapq.heappush(heap, (now + ev.duration_s, next(seq),
                                      "recover", r.name))
            elif ev.kind == "degrade":
                r.degrade(now, ev.magnitude, ev.duration_s)
                tracer.event("fault", now, resource="faults",
                             kind=ev.kind, replica=r.name,
                             factor=ev.magnitude)
                heapq.heappush(heap, (now + ev.duration_s, next(seq),
                                      "recover", r.name))
            elif ev.kind == "kv-spike":
                r.kv_spike(now, ev.magnitude, ev.duration_s)
                tracer.event("fault", now, resource="faults",
                             kind=ev.kind, replica=r.name,
                             bias_s=ev.magnitude)
                heapq.heappush(heap, (now + ev.duration_s, next(seq),
                                      "recover", r.name))

        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            self.pool.tick(now - prev)
            prev = now
            if brown is not None:
                pressure_event(0.0, now)
            for r in self.pool.replicas:
                if r.state != STOPPED:
                    r.poke(now)
                    # queued work past its deadline is shed before it
                    # burns joules (rejected-with-reason by the server)
                    r.server.shed_expired(now)

            if kind == "fault":
                apply_fault(payload, now)
                continue
            if kind == "recover":
                r = self.pool.by_name(payload)
                was_failed = r.health.status == "failed"
                r.recover(now, self.recovering_s if was_failed else 0.0)
                tracer.event("recover", now, resource="faults",
                             replica=r.name, health=r.health.status)
                if was_failed and self.recovering_s > 0.0:
                    heapq.heappush(heap, (now + self.recovering_s,
                                          next(seq), "heal", r.name))
                continue
            if kind == "heal":
                r = self.pool.by_name(payload)
                if r.health.status == "recovering":
                    r.health.heal()
                continue

            req = payload
            if n_arrivals % self.scale_every == 0:
                if self.autoscaler is not None:
                    acts = self.autoscaler.observe(now, self.pool)
                    for act, name in acts or ():
                        tracer.event("autoscale", now,
                                     resource="autoscaler",
                                     action=act, replica=name)
                if metrics.enabled:
                    self._export_gauges(metrics, now)
            n_arrivals += 1

            if now >= request_expiry(req):
                reject(req, now, "deadline-expired")
                continue
            if now < link_down_until:
                requeue(req, now, "link-flap",
                        not_before=link_down_until)
                continue
            candidates = self.pool.routable_for(req)
            if not candidates:
                requeue(req, now, "no-routable-replica")
                continue
            replica = self.router.route(req, candidates, now)
            by_rid[req.rid] = req
            replica.push(req)

        responses = list(fleet_out)
        for r in self.pool.replicas:
            responses.extend(r.finish(prev))
        # retried requests report END-TO-END latency: restore the
        # original arrival on whatever response their rid ended with
        for resp in responses:
            t0 = orig_arrival.get(resp.rid)
            if t0 is not None:
                resp.arrival_s = t0
        responses.sort(key=lambda x: x.rid)
        if metrics.enabled:
            self._export_gauges(metrics, prev)

        # the fleet span ends at the last completion ANYWHERE (a
        # drained replica's final flush can be the latest event);
        # powered-on time only extends on still-active replicas
        fleet_finish = max((x.t_finish for x in responses),
                           default=prev)
        for r in self.pool.replicas:
            if r.state != STOPPED:
                tail = max((x.t_finish for x in r.server.responses),
                           default=prev)
                r.active_s += max(tail - prev, 0.0)

        return self._report(responses, first, fleet_finish,
                            stats=stats)

    # -- reporting -----------------------------------------------------------
    def _report(self, responses, first: float, finish: float,
                stats: dict | None = None) -> FleetReport:
        from repro_torch.serving.api import PATH_REJECT
        n = len(responses)
        span = max(finish - first, 1e-9)
        total_j = self.pool.energy_j()
        self.carbon.meter.record(total_j, n_requests=max(n, 1))
        lat = np.array([r.t_finish - r.arrival_s for r in responses]
                       or [0.0])
        correct = [int(r.output) == int(r.label) for r in responses
                   if r.label is not None and np.isscalar(r.output)]
        rejected = [r for r in responses if r.path == PATH_REJECT]
        n_expired = sum(1 for r in rejected
                        if r.telemetry.get("reason") == "deadline-expired")
        stats = stats or {}
        summary = {
            "n": n,
            "n_replicas": len(self.pool),
            "router": type(self.router).__name__,
            "span_s": round(span, 4),
            "throughput_qps": round(n / span, 2),
            "mean_latency_ms": round(float(lat.mean()) * 1e3, 3),
            "p95_latency_ms": round(
                float(np.percentile(lat, 95)) * 1e3, 3),
            "energy_j": round(total_j, 3),
            "joules_per_request": round(total_j / max(n, 1), 4),
            "accuracy": (round(float(np.mean(correct)), 4)
                         if correct else float("nan")),
            "admission_rate": (round(float(np.mean(
                [r.admitted for r in responses])), 4)
                if responses else float("nan")),
            "routed": {r.name: r.n_routed for r in self.pool},
            # failure model (all zero on a fault-free run)
            "n_served": n - len(rejected),
            "n_rejected": len(rejected),
            "n_expired": n_expired,
            "n_retries": int(stats.get("n_retries", 0)),
            "n_failures": int(stats.get("n_failures", 0)),
            "wasted_j": round(sum(r.wasted_j for r in self.pool), 4),
            "served_frac": round((n - len(rejected)) / max(n, 1), 4),
            "brownout_min_scale": (
                round(self.brownout.min_scale_seen, 4)
                if self.brownout is not None else 1.0),
        }
        return FleetReport(
            responses=responses,
            per_replica=[r.report() for r in self.pool],
            summary=summary,
            carbon=self.carbon.report(),
            autoscaler_log=(list(self.autoscaler.log)
                            if self.autoscaler else []))
