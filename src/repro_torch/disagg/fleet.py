"""Separate prefill and decode replica pools over the split-phase
engine — the closed-loop fleet layer of disaggregated serving, ported
from ``repro.disagg.fleet``.

Topology: N prefill workers and M decode workers share ONE set of
weights (one :class:`PrefillEngine`, one
:class:`ContinuousBatchingEngine` — each worker owns its own
``ServiceLine``/``DecodeSession``, modelling N+M devices without
holding N+M parameter copies).  A :class:`TransferQueue` links the
phases.  Routing happens twice per request — once into a prefill
basin, once (at send time) into a decode basin — through a
:class:`PhaseAwareRouter` whose congestion term multiplies queue
backlog by the phase's RESOURCE pressure: always 0 for prefill (it
holds no state between requests), slot/block occupancy for decode
(from the worker's ``DecodeSession``).  That asymmetry is the point:
prefill basins saturate on compute backlog, decode basins on KV
residency, and the router sees each phase's true bottleneck.

Each phase gets its OWN :class:`Autoscaler` (via :class:`PhasePool`
views), so a prompt burst revives prefill workers while long decode
drains revive decode workers — the paper's closed-loop energy/latency
trade-off, applied per phase.

On the card every worker runs on the one device, one call at a time,
and each measured call ends in a host read (a prefill's first token, a
window's tokens), so one worker's walltime never holds another's work.
A decode session captures its window as a CUDA graph, once per kind;
the reference compiles its window once per engine, the port captures
once per session, and a crashed worker's new session captures again.
A capture (and the uncaptured first window before it) is set-up, not
decode work: a worker's session is warmed (``DecodeSession.warm``) when
the worker is built and when a crash replaces it, before any window is
timed, so neither reaches the virtual clock or the joules EWMA; the
worker counts its sessions' captures apart (``captures``,
``capture_s``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.energy import EnergyModel
from repro_torch.disagg.engine import PrefillEngine, PrefillResult
from repro_torch.disagg.transfer import Transfer, TransferQueue
from repro_torch.faults.health import FAILED, HealthState
from repro_torch.fleet.autoscaler import Autoscaler
from repro_torch.fleet.replica import ACTIVE, STOPPED
from repro_torch.fleet.router import EnergyAwareRouter
from repro_torch.serving.batcher import ServiceLine
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            DecodeSession, GenRequest)
from repro_torch.telemetry.metrics import NULL_METRICS
from repro_torch.telemetry.trace import NULL_TRACER


class _PhaseWorker:
    """State shared by both worker kinds: one ServiceLine, activity
    accounting, and the closed-loop joules/request EWMA the router and
    autoscaler read.  ``controller`` stays None — phase admission is
    the front-end server's job, not the pool's — so the router's
    basin test accepts every worker and score order decides."""

    def __init__(self, name: str, *, utility: float = 1.0,
                 energy_prior_j: float = 1.0,
                 energy_model: EnergyModel | None = None,
                 ewma: float = 0.3):
        self.name = name
        self.state = ACTIVE
        self.utility = utility
        self.controller = None
        self.energy_model = energy_model or EnergyModel()
        self.line = ServiceLine()
        self.busy_s = 0.0
        self.active_s = 0.0
        self.n_served = 0
        self.health = HealthState()
        self.pressure_bias_s = 0.0         # kv-spike congestion bias
        self._jpr = float(energy_prior_j)
        self._ewma = ewma

    @property
    def routable(self) -> bool:
        return self.state == ACTIVE and self.health.routable

    @property
    def revivable(self) -> bool:
        """Parked capacity the autoscaler (or the simulator's
        scaled-to-zero guard) may wake; FAILED workers only return
        through their scheduled recovery."""
        return self.state == STOPPED and self.health.status != FAILED

    def tick(self, dt: float) -> None:
        if self.state == ACTIVE:
            self.active_s += dt

    def _record(self, dur: float) -> None:
        self.busy_s += dur
        self.n_served += 1
        j = self.energy_model.p_active * dur
        self._jpr += self._ewma * (j - self._jpr)

    def joules_per_request(self) -> float:
        return self._jpr

    def energy_j(self) -> float:
        m = self.energy_model
        idle = max(self.active_s - self.busy_s, 0.0)
        return m.p_active * self.busy_s + m.p_idle * idle

    def pressure(self, now: float) -> float:
        return self.line.backlog(now) + self.pressure_bias_s

    def resource_pressure(self, now: float) -> float:
        return 0.0

    def drain(self, now: float) -> None:
        self.state = STOPPED

    def revive(self) -> None:
        self.state = ACTIVE

    # -- faults (repro_torch.faults) -----------------------------------
    def crash(self, now: float, duration_s: float = 0.5) -> list[int]:
        """The worker dies; returns the rids of whatever generation
        state it was holding (nothing, for a stateless phase)."""
        self.state = STOPPED
        self.health.fail(now, duration_s)
        self.line.reset()
        return []

    def degrade(self, now: float, factor: float,
                duration_s: float) -> None:
        self.health.degrade(now, factor, duration_s)

    def kv_spike(self, now: float, bias_s: float,
                 duration_s: float) -> None:
        self.health.degrade(now, 1.0, duration_s)
        self.pressure_bias_s = max(self.pressure_bias_s, float(bias_s))

    def recover(self, now: float, recovering_s: float = 0.0) -> None:
        self.health.recover(now, recovering_s)
        self.pressure_bias_s = 0.0
        if self.state == STOPPED:
            self.revive()


class PrefillWorker(_PhaseWorker):
    """One compute-bound device: serialises prompt prefills on its
    line.  Stateless between requests — its resource pressure is
    always zero; backlog seconds are its only congestion signal."""

    def __init__(self, name: str, engine: PrefillEngine, **kw):
        super().__init__(name, **kw)
        self.engine = engine

    def prefill(self, r: GenRequest, now: float, *,
                prompt_len: int | None = None
                ) -> tuple[PrefillResult, float, float]:
        t0 = time.perf_counter()
        pr = self.engine.prefill(r, prompt_len=prompt_len)
        # a degraded (slow) node stretches its measured walltime
        dt = (time.perf_counter() - t0) * self.health.slow_factor
        start, finish = self.line.reserve(now, dt)
        self._record(dt)
        return pr, start, finish


class DecodeWorker(_PhaseWorker):
    """One HBM-bound device: a ``DecodeSession`` slot pool plus a
    line for its fused windows.  Resource pressure is KV residency —
    occupied-slot fraction, and for paged pools the block-pool fill,
    whichever is scarcer — the signal the phase-aware router
    multiplies into this basin's congestion."""

    def __init__(self, name: str, engine: ContinuousBatchingEngine,
                 **kw):
        super().__init__(name, **kw)
        self.engine = engine
        self.captures = 0              # window captures, every session's
        self.capture_s = 0.0           # their seconds, off the clock
        self.session = self._fresh_session()

    def _fresh_session(self) -> DecodeSession:
        """A new session with its windows captured, untimed."""
        s = DecodeSession(self.engine).warm()
        self.captures += s.captures
        self.capture_s += s.capture_s
        return s

    def insert(self, pr: PrefillResult) -> None:
        self.session.insert_prefilled(pr.request, pr.rows,
                                      pr.first_token, pr.plen)

    def advance(self, now: float) -> tuple[list[GenRequest], float,
                                           float]:
        t0 = time.perf_counter()
        finished = self.session.advance()
        dt = (time.perf_counter() - t0) * self.health.slow_factor
        start, finish = self.line.reserve(now, dt)
        self.busy_s += dt
        self.n_served += len(finished)
        # fold the window's energy into the EWMA per completed request
        if finished:
            j = self.energy_model.p_active * dt / len(finished)
            self._jpr += self._ewma * (j - self._jpr)
        return finished, start, finish

    @property
    def idle(self) -> bool:
        return self.session.idle

    def pressure(self, now: float) -> float:
        backlog = self.line.backlog(now)
        waiting = (self.session.n_queued
                   + len(self.session._insert_q))
        # queued inserts cost roughly one window each until seated
        est = self.engine.sync_every * 0.001
        return backlog + waiting * est

    def resource_pressure(self, now: float) -> float:
        slots = self.session.n_active / max(self.engine.n_slots, 1)
        if not self.engine.paged:
            return slots
        allocatable = max(self.engine.pool_blocks - 1, 1)
        used = allocatable - len(self.session._free_blocks)
        return max(slots, used / allocatable)

    def drain(self, now: float) -> None:
        # flush the session dry through the ordinary advance path —
        # nothing is dropped; the caller harvests via run()'s sweep
        self.state = STOPPED

    def crash(self, now: float, duration_s: float = 0.5) -> list[int]:
        """The decode device dies: every request holding a slot, queued,
        or awaiting insertion loses its generation state.  Returns the
        lost rids so the simulator can re-prefill them; the session is
        rebuilt fresh (its KV pool is gone) and warmed, untimed."""
        s = self.session
        lost = [g.rid for g in s.slots if g is not None]
        lost += [g.rid for g in s.queue]
        lost += [item[0].rid for item in s._insert_q]
        # the old pool and its captured graphs go with the old session,
        # before the new one allocates its own
        del s
        self.session = None
        self.session = self._fresh_session()
        self.state = STOPPED
        self.health.fail(now, duration_s)
        self.line.reset()
        return lost


class PhasePool:
    """One phase's workers behind the ``Autoscaler`` pool protocol
    (``replicas``/``routable``/``energy_j``/``n_served``/``drain``/
    ``revive``), so the SAME hysteresis policy that scales the
    classifier fleet scales each phase independently."""

    def __init__(self, workers: list):
        self.replicas = list(workers)

    def routable(self) -> list:
        return [w for w in self.replicas if w.routable]

    def energy_j(self) -> float:
        return sum(w.energy_j() for w in self.replicas)

    def n_served(self) -> int:
        return sum(w.n_served for w in self.replicas)

    def drain(self, w, now: float) -> None:
        w.drain(now)

    def revive(self, w) -> None:
        w.revive()

    def tick(self, dt: float) -> None:
        for w in self.replicas:
            w.tick(dt)


class PhaseAwareRouter(EnergyAwareRouter):
    """Energy-aware scoring with the phase's resource pressure folded
    into congestion: decode basins pay for KV residency (slots/blocks
    about to run out make a basin expensive even when its line is
    momentarily free), prefill basins only for backlog."""

    def congestion(self, replica, now: float, slo_s: float) -> float:
        base = super().congestion(replica, now, slo_s)
        rp = getattr(replica, "resource_pressure", None)
        return base * (1.0 + (rp(now) if rp is not None else 0.0))


@dataclass
class DisaggPool:
    """The full disaggregated fleet: both phase pools + the link."""
    prefill_workers: list
    decode_workers: list
    transfer: TransferQueue

    @property
    def prefill(self) -> PhasePool:
        return PhasePool(self.prefill_workers)

    @property
    def decode(self) -> PhasePool:
        return PhasePool(self.decode_workers)

    def tick(self, dt: float) -> None:
        for w in self.prefill_workers + self.decode_workers:
            w.tick(dt)


def build_disagg_fleet(cfg, params, *, n_prefill: int = 1,
                       n_decode: int = 1, n_slots: int = 4,
                       max_seq: int = 64, sync_every: int = 8,
                       gbps: float = 16.0,
                       draft_depth: int = 0,
                       energy_model: EnergyModel | None = None,
                       device="cuda") -> DisaggPool:
    """N prefill + M decode workers over ONE weight copy on ``device``
    (the card by default).

    Workers share the phase engines (one ``PrefillEngine``, one
    ``ContinuousBatchingEngine``, one model), so fleet size scales
    device lines and sessions, not kernel builds or parameter memory;
    each decode worker's session holds its own pool and captures its
    own window.  ``draft_depth > 0`` gives the decode workers the
    self-speculative window (needs ``cfg.draft_layers``; contiguous KV
    only).  ``energy_model`` defaults to ``EnergyModel()``; the launcher
    passes the card's constant set."""
    em = energy_model or EnergyModel()
    de = ContinuousBatchingEngine(cfg, params, n_slots=n_slots,
                                  max_seq=max_seq,
                                  sync_every=sync_every,
                                  draft_depth=draft_depth, device=device)
    pe = PrefillEngine(cfg, de.params, max_seq=max_seq, device=de.device)
    prefill = [PrefillWorker(f"prefill-{i}", pe, energy_model=em)
               for i in range(n_prefill)]
    decode = [DecodeWorker(f"decode-{i}", de, energy_model=em)
              for i in range(n_decode)]
    return DisaggPool(prefill_workers=prefill, decode_workers=decode,
                      transfer=TransferQueue(gbps=gbps))


@dataclass
class DisaggReport:
    responses: list
    summary: dict
    per_worker: dict
    transfer: dict
    autoscaler_log: dict


@dataclass
class DisaggSimulator:
    """Drive generate-kind requests through the disaggregated fleet
    on one virtual clock: route to a prefill basin at arrival, send
    the KV down the link at prefill finish (decode basin chosen at
    send time), seat landed transfers and advance decode windows as
    the stream progresses, then drain past the last in-flight
    transfer.  Each phase's autoscaler observes every
    ``scale_every`` arrivals."""
    pool: DisaggPool
    router: PhaseAwareRouter = field(default_factory=PhaseAwareRouter)
    prefill_scaler: Autoscaler | None = None
    decode_scaler: Autoscaler | None = None
    prompt_len: int | None = None
    scale_every: int = 20
    tracer: object = None              # telemetry.trace recorder; None=off
    metrics: object = None             # telemetry.metrics registry; None=off
    # -- failure model (repro_torch.faults) ---------------------------------
    injector: object = None            # faults.FaultInjector; None = off
    retry_policy: object = None        # faults.RetryPolicy; None = default
    recovering_s: float = 0.05         # warm-up after a crash window

    def _decode_worker(self, name: str) -> DecodeWorker:
        for w in self.pool.decode_workers:
            if w.name == name:
                return w
        import difflib
        names = [w.name for w in self.pool.decode_workers]
        msg = f"unknown decode worker {name!r}; pool has {names}"
        close = difflib.get_close_matches(name, names, n=1, cutoff=0.4)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        raise KeyError(msg)

    def _worker(self, name: str):
        """Any phase worker by name (fault-plan target resolution)."""
        for w in (self.pool.prefill_workers + self.pool.decode_workers):
            if w.name == name:
                return w
        import difflib
        names = [w.name for w in (self.pool.prefill_workers
                                  + self.pool.decode_workers)]
        msg = f"unknown worker {name!r}; pool has {names}"
        close = difflib.get_close_matches(name, names, n=1, cutoff=0.4)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        raise KeyError(msg)

    def _export_gauges(self, metrics, now: float) -> None:
        """Per-worker gauges each scale tick: pressure, KV-residency
        pressure, EnergyMeter-style J/request EWMA, τ(t) and admission
        rate (phase workers carry no controller — admission happens at
        the front end — so τ is +Inf / admission 1.0: open loop)."""
        for phase, workers in (("prefill", self.pool.prefill_workers),
                               ("decode", self.pool.decode_workers)):
            for w in workers:
                lab = {"replica": w.name, "phase": phase}
                metrics.gauge("fleet_pressure",
                              "backlog seconds per worker").set(
                    w.pressure(now), **lab)
                metrics.gauge("fleet_resource_pressure",
                              "KV residency / slot occupancy").set(
                    w.resource_pressure(now), **lab)
                metrics.gauge("fleet_joules_per_request",
                              "closed-loop J/request EWMA").set(
                    w.joules_per_request(), **lab)
                metrics.gauge("fleet_n_served",
                              "requests served so far").set(
                    w.n_served, **lab)
                ctl = w.controller
                tau, admit = float("inf"), 1.0
                if ctl is not None:
                    tau = ctl.peek(now)[0]
                    admit = ctl.admission_rate
                metrics.gauge("fleet_tau",
                              "admission threshold τ(t)").set(
                    tau, **lab)
                metrics.gauge("fleet_admission_rate",
                              "fraction admitted").set(admit, **lab)
                sess = getattr(w, "session", None)
                if (sess is not None
                        and getattr(sess.engine, "draft_depth", 0) > 0):
                    st = sess.stats()
                    metrics.gauge(
                        "decode_acceptance_rate",
                        "speculative draft acceptance rate").set(
                        float(st.get("acceptance_rate", 0.0)), **lab)
                    metrics.gauge(
                        "decode_draft_depth",
                        "live speculative draft depth").set(
                        float(st.get("draft_depth_live", 0)), **lab)
        metrics.gauge("fleet_pressure").set(
            self.pool.transfer.pressure(now),
            replica="link", phase="transfer")

    def _deliver(self, now: float, *, everything: bool = False
                 ) -> list[Transfer]:
        landed = (self.pool.transfer.deliver_all() if everything
                  else self.pool.transfer.deliver(now))
        for t in landed:
            w = self._decode_worker(t.dst)
            if w.health.status == FAILED:
                # landed on a dead worker: the KV has nowhere to seat;
                # the run loop re-ships it to a live basin
                self._orphans.append(t)
                continue
            w.insert(t.result)
            self._arrived[t.result.request.rid] = t.arrive_t
        return landed

    def _advance_ready(self, now: float, finish_t: dict) -> None:
        tracer = self._tracer
        for w in self.pool.decode_workers:
            if w.session.idle:
                continue
            finished, wstart, fin = w.advance(now)
            if tracer.enabled and fin > wstart:
                tracer.span("decode.window", wstart, fin,
                            resource=w.name, finished=len(finished),
                            active=w.session.n_active)
            for g in finished:
                finish_t[g.rid] = (fin, w.name)
                if not tracer.enabled:
                    continue
                root = self._roots.pop(g.rid, None)
                # decode occupancy: the request holds one slot from
                # (KV landed, slot free) until its finishing window —
                # slot exclusivity makes the per-slot track non-overlap
                if g.slot is not None:
                    res = f"{w.name}/slot{g.slot}"
                    dstart = max(self._arrived.get(g.rid, wstart),
                                 self._slot_free.get(res, 0.0))
                    dstart = min(dstart, fin)
                    self._slot_free[res] = fin
                    tracer.span("decode", dstart, fin, parent=root,
                                resource=res, rid=g.rid,
                                n_tokens=len(g.generated))
                if root is not None:
                    tracer.end(root, fin, decode_worker=w.name)

    def run(self, requests: list) -> DisaggReport:
        import heapq
        import itertools

        from repro_torch.faults.retry import RetryPolicy
        from repro_torch.serving.api import request_expiry

        reqs = sorted(requests, key=lambda r: r.arrival_s)
        gen: dict[int, GenRequest] = {}
        meta: dict[int, object] = {}
        finish_t: dict[int, tuple] = {}
        prefill_of: dict[int, str] = {}
        decode_of: dict[int, str] = {}
        rejected: dict[int, tuple] = {}      # rid -> (reason, t)
        attempts: dict[int, int] = {}
        stats = {"n_retries": 0, "n_failures": 0, "n_retransmits": 0}
        retry = self.retry_policy or RetryPolicy()
        tracer = self._tracer = (self.tracer if self.tracer is not None
                                 else NULL_TRACER)
        metrics = (self.metrics if self.metrics is not None
                   else NULL_METRICS)
        self._roots: dict[int, object] = {}
        self._arrived: dict[int, float] = {}
        self._slot_free: dict[str, float] = {}
        self._orphans: list[Transfer] = []
        if self.injector is not None:
            self.injector.reset()

        seq = itertools.count()
        heap: list = []
        for req in reqs:
            heapq.heappush(heap, (float(req.arrival_s), next(seq),
                                  "arrival", req))
        if self.injector is not None:
            for ev in self.injector.plan.events:
                heapq.heappush(heap, (float(ev.t), next(seq),
                                      "fault", ev))
        now = 0.0
        n_arrivals = 0

        def reject(rid: int, t: float, reason: str) -> None:
            rejected[rid] = (reason, t)
            root = self._roots.pop(rid, None)
            if root is not None:
                tracer.end(root, t, error=reason)
            tracer.event("reject", t, resource="faults", rid=rid,
                         reason=reason)
            metrics.counter("fleet_expired",
                            "requests rejected, by reason").inc(
                reason=reason.split(":", 1)[0])

        def budget(rid: int, t: float, reason: str) -> bool:
            """Consume one retry attempt; on an exhausted budget the
            request terminates as a rejection-with-reason, never a hang."""
            a = attempts.get(rid, 0) + 1
            if retry.allows(a):
                attempts[rid] = a
                stats["n_retries"] += 1
                metrics.counter("fleet_retries",
                                "retried hand-offs, by reason").inc(
                    reason=reason)
                tracer.event("retry", t, resource="faults", rid=rid,
                             attempt=a, reason=reason)
                return True
            reject(rid, t, f"retry-budget:{reason}")
            return False

        def delay(rid: int) -> float:
            return retry.delay(max(attempts.get(rid, 1), 1))

        def pick(req, t: float, phase: PhasePool, workers: list):
            """Route into a phase basin; wakes PARKED capacity when the
            phase scaled to zero (FAILED nodes only return through
            their own scheduled recovery)."""
            ws = phase.routable()
            if not ws:
                for w in workers:
                    if w.revivable:
                        w.revive()
                        break
                ws = phase.routable()
            if not ws:
                return None
            return self.router.route(req, ws, t)

        def send_kv(req, pr, t: float, root) -> bool:
            """Choose a decode basin and ship the KV; False when no
            decode capacity is up (caller schedules a resend)."""
            dw = pick(req, t, self.pool.decode,
                      self.pool.decode_workers)
            if dw is None:
                return False
            tr = self.pool.transfer.send(pr, t, dst=dw.name)
            decode_of[req.rid] = dw.name
            if tracer.enabled:
                if tr.start_t > tr.send_t:
                    tracer.span("transfer.wait", tr.send_t, tr.start_t,
                                parent=root, rid=req.rid)
                tracer.span("transfer", tr.start_t, tr.arrive_t,
                            parent=root, resource="link", rid=req.rid,
                            bytes=tr.n_bytes, dst=dw.name)
            return True

        def dispatch(req, t: float, *, fresh_root: bool) -> None:
            """Prefill + hand-off for one request — the original
            arrival, or a re-prefill after a decode crash lost its
            generation state (same root span: one request, one trace)."""
            rid = req.rid
            g = GenRequest(rid=rid,
                           prompt=np.asarray(req.payload, np.int32),
                           max_new=getattr(req, "max_new", 16),
                           arrival_t=t,
                           eos_id=(getattr(req, "metadata", None)
                                   or {}).get("eos_id"))
            gen[rid] = g
            meta[rid] = req
            root = self._roots.get(rid)
            if tracer.enabled and fresh_root:
                root = tracer.begin("request", t, rid=rid,
                                    kind="generate")
                self._roots[rid] = root
            pw = pick(req, t, self.pool.prefill,
                      self.pool.prefill_workers)
            if pw is None:
                if budget(rid, t, "no-prefill-worker"):
                    heapq.heappush(heap, (t + delay(rid), next(seq),
                                          "redo", req))
                return
            pr, pstart, fin = pw.prefill(g, t,
                                         prompt_len=self.prompt_len)
            prefill_of[rid] = pw.name
            if tracer.enabled:
                tracer.span("prefill", pstart, fin, parent=root,
                            resource=pw.name, rid=rid,
                            plen=pr.plen, kv_bytes=pr.kv_bytes)
            if not send_kv(req, pr, fin, root):
                if budget(rid, t, "no-decode-worker"):
                    heapq.heappush(heap, (fin + delay(rid), next(seq),
                                          "resend", pr))

        def retransmit(pr, t: float) -> None:
            """Re-ship a prefilled KV whose transfer (or destination)
            was lost; the prefill itself is NOT redone."""
            rid = pr.request.rid
            if rid in finish_t or rid in rejected:
                return
            stats["n_retransmits"] += 1
            root = self._roots.get(rid)
            if not send_kv(meta[rid], pr, t, root):
                if budget(rid, t, "no-decode-worker"):
                    heapq.heappush(heap, (t + delay(rid), next(seq),
                                          "resend", pr))

        def requeue_orphans(t: float) -> None:
            orphans, self._orphans = self._orphans, []
            for tr in orphans:
                rid = tr.result.request.rid
                if rid in finish_t or rid in rejected:
                    continue
                if budget(rid, t, "decode-worker-lost"):
                    heapq.heappush(heap, (t + delay(rid), next(seq),
                                          "resend", tr.result))

        def apply_fault(ev, t: float) -> None:
            stats["n_failures"] += 1
            metrics.counter("fleet_failures",
                            "injected faults, by kind").inc(
                kind=ev.kind, target=ev.target or "auto")
            if ev.kind == "link-flap":
                lost = self.pool.transfer.flap(t, ev.duration_s)
                tracer.event("fault", t, resource="faults",
                             kind=ev.kind, n_lost=len(lost),
                             until=self.pool.transfer.outage_until)
                out_end = self.pool.transfer.outage_until
                for tr in lost:
                    rid = tr.result.request.rid
                    if budget(rid, t, "link-flap"):
                        heapq.heappush(heap, (out_end + delay(rid),
                                              next(seq), "resend",
                                              tr.result))
                return
            w = (self._worker(ev.target) if ev.target else next(
                (x for x in self.pool.decode_workers
                 if x.state == ACTIVE), None))
            if w is None:
                return
            if ev.kind == "crash":
                lost = w.crash(t, ev.duration_s)
                dropped = self.pool.transfer.drop_to(w.name)
                tracer.event("fault", t, resource="faults",
                             kind=ev.kind, replica=w.name,
                             n_lost=len(lost) + len(dropped))
                for rid in lost:
                    if rid in finish_t or rid in rejected:
                        continue
                    if budget(rid, t, "decode-crash"):
                        heapq.heappush(heap, (t + delay(rid),
                                              next(seq), "redo",
                                              meta[rid]))
                for tr in dropped:
                    rid = tr.result.request.rid
                    if rid in finish_t or rid in rejected:
                        continue
                    if budget(rid, t, "decode-crash"):
                        heapq.heappush(heap, (t + delay(rid),
                                              next(seq), "resend",
                                              tr.result))
                heapq.heappush(heap, (t + ev.duration_s, next(seq),
                                      "recover", w.name))
            elif ev.kind == "degrade":
                w.degrade(t, ev.magnitude, ev.duration_s)
                tracer.event("fault", t, resource="faults",
                             kind=ev.kind, replica=w.name,
                             factor=ev.magnitude)
                heapq.heappush(heap, (t + ev.duration_s, next(seq),
                                      "recover", w.name))
            elif ev.kind == "kv-spike":
                w.kv_spike(t, ev.magnitude, ev.duration_s)
                tracer.event("fault", t, resource="faults",
                             kind=ev.kind, replica=w.name,
                             bias_s=ev.magnitude)
                heapq.heappush(heap, (t + ev.duration_s, next(seq),
                                      "recover", w.name))

        def observe_scalers(t: float) -> None:
            for phase, scaler, pool in (
                    ("prefill", self.prefill_scaler, self.pool.prefill),
                    ("decode", self.decode_scaler, self.pool.decode)):
                if not scaler:
                    continue
                acts = scaler.observe(t, pool)
                for kind, name in acts or ():
                    tracer.event("autoscale", t, resource="autoscaler",
                                 phase=phase, action=kind,
                                 replica=name)
            if metrics.enabled:
                self._export_gauges(metrics, t)

        while True:
            while heap:
                t, _, ekind, payload = heapq.heappop(heap)
                self.pool.tick(max(t - now, 0.0))
                now = max(now, t)
                self._deliver(now)
                requeue_orphans(now)
                if ekind == "fault":
                    apply_fault(payload, now)
                    continue
                if ekind == "recover":
                    w = self._worker(payload)
                    was_failed = w.health.status == FAILED
                    w.recover(now, self.recovering_s if was_failed
                              else 0.0)
                    tracer.event("recover", now, resource="faults",
                                 replica=w.name,
                                 health=w.health.status)
                    if was_failed and self.recovering_s > 0.0:
                        heapq.heappush(heap,
                                       (now + self.recovering_s,
                                        next(seq), "heal", w.name))
                    continue
                if ekind == "heal":
                    w = self._worker(payload)
                    if w.health.status == "recovering":
                        w.health.heal()
                    continue
                if ekind == "resend":
                    retransmit(payload, now)
                    self._advance_ready(now, finish_t)
                    continue
                if ekind == "redo":
                    req = payload
                    if req.rid in finish_t or req.rid in rejected:
                        continue
                    if now >= request_expiry(req):
                        reject(req.rid, now, "deadline-expired")
                        continue
                    dispatch(req, now, fresh_root=False)
                    self._advance_ready(now, finish_t)
                    continue
                # arrival
                req = payload
                meta[req.rid] = req
                if now >= request_expiry(req):
                    if tracer.enabled:
                        self._roots[req.rid] = tracer.begin(
                            "request", now, rid=req.rid,
                            kind="generate")
                    reject(req.rid, now, "deadline-expired")
                    continue
                dispatch(req, now, fresh_root=True)
                self._deliver(now)
                self._advance_ready(now, finish_t)
                n_arrivals += 1
                if n_arrivals % self.scale_every == 0:
                    observe_scalers(now)
            # drain: fast-forward past the slowest in-flight transfer
            # — and past any link outage still in effect
            horizon = max([now, self.pool.transfer.outage_until]
                          + [t.arrive_t
                             for t in self.pool.transfer.inflight])
            self.pool.tick(max(horizon - now, 0.0))
            now = horizon
            self._deliver(now, everything=True)
            requeue_orphans(now)
            while any(not w.session.idle
                      for w in self.pool.decode_workers
                      if w.health.status != FAILED):
                self._advance_ready(now, finish_t)
            if not heap:
                break
        if tracer.enabled and self._roots:
            # every request must harvest through _advance_ready; a
            # leftover root is a lost request — flag it for the validator
            for root in self._roots.values():
                tracer.end(root, now, error="unfinished")
            self._roots.clear()
        responses = []
        for req in reqs:
            rej = rejected.get(req.rid)
            if rej is not None:
                reason, t_rej = rej
                responses.append({
                    "rid": req.rid,
                    "tokens": [],
                    "arrival_s": float(req.arrival_s),
                    "t_finish": t_rej,
                    "latency_s": t_rej - float(req.arrival_s),
                    "prefill_worker": prefill_of.get(req.rid, ""),
                    "decode_worker": decode_of.get(req.rid, ""),
                    "rejected": reason,
                })
                continue
            g = gen[req.rid]
            fin, dname = finish_t.get(req.rid, (now, ""))
            responses.append({
                "rid": req.rid,
                "tokens": list(g.generated),
                "arrival_s": float(req.arrival_s),
                "t_finish": fin,
                "latency_s": fin - float(req.arrival_s),
                "prefill_worker": prefill_of.get(req.rid, ""),
                "decode_worker": decode_of.get(req.rid, ""),
            })
        served = [r for r in responses if "rejected" not in r]
        lats = np.array([r["latency_s"] for r in served])
        n_tokens = int(sum(len(r["tokens"]) for r in responses))
        energy = (self.pool.prefill.energy_j()
                  + self.pool.decode.energy_j())
        summary = {
            "n": len(responses),
            "n_tokens": n_tokens,
            "energy_j": energy,
            "joules_per_token": (energy / n_tokens
                                 if n_tokens else 0.0),
            "p50_latency_ms": float(np.percentile(lats, 50) * 1e3)
            if len(lats) else 0.0,
            "p95_latency_ms": float(np.percentile(lats, 95) * 1e3)
            if len(lats) else 0.0,
            "span_s": now,
            "prefill_energy_j": self.pool.prefill.energy_j(),
            "decode_energy_j": self.pool.decode.energy_j(),
            "n_served": len(served),
            "n_rejected": len(rejected),
            "n_retries": stats["n_retries"],
            "n_failures": stats["n_failures"],
            "n_retransmits": stats["n_retransmits"],
        }
        per_worker = {
            w.name: {"n_served": w.n_served,
                     "busy_s": round(w.busy_s, 6),
                     "energy_j": round(w.energy_j(), 6),
                     "state": w.state}
            for w in (self.pool.prefill_workers
                      + self.pool.decode_workers)
        }
        if metrics.enabled:
            self._export_gauges(metrics, now)
            metrics.gauge("fleet_energy_j",
                          "modelled joules by phase pool").set(
                self.pool.prefill.energy_j(), phase="prefill")
            metrics.gauge("fleet_energy_j").set(
                self.pool.decode.energy_j(), phase="decode")
        return DisaggReport(
            responses=responses, summary=summary,
            per_worker=per_worker,
            transfer=self.pool.transfer.stats(),
            autoscaler_log={
                "prefill": (self.prefill_scaler.log
                            if self.prefill_scaler else []),
                "decode": (self.decode_scaler.log
                           if self.decode_scaler else []),
            })
