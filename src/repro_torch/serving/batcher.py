"""Dual-path scheduling primitives — THE batching model of the repo.

Two small cores compose into every scheduler (the serving adapters and
the fleet's virtual-time engines wrap these instead of re-modelling
them, so the Table-2 benchmark and the fleet sweeps measure one code
path):

``BatchQueue``  — the window/size flush policy: requests queue until
either ``max_batch_size`` is reached or ``queue_window_s`` has elapsed
since the oldest queued request; ``preferred_sizes`` mirrors Triton's
preferred_batch_size hint (timeout flushes round down to the largest
preferred size; stragglers stay queued and re-flush in arrival order).
The queue only *forms* request groups — service timing is the
caller's.

``ServiceLine`` — free-at serialisation of one logical device:
``reserve(t, dur)`` starts work no earlier than the line is free and
advances the horizon.

``DirectPath``   — FastAPI+ORT analogue: serial per-request execution,
minimal fixed overhead (a bare ``ServiceLine``).

``DynamicBatcher`` — Triton analogue: ``BatchQueue`` + ``ServiceLine``
with the fused batch served in one modelled step.

All are *virtual-time* schedulers: they operate on an explicit clock
so the discrete-event simulator and the live engine share one code
path (the live engine advances the clock with measured walltimes).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.landscape import LatencyModel
from repro_torch.serving.workload import Request


@dataclass
class Batch:
    requests: list[Request]
    t_formed: float                  # when the batch was closed
    t_start: float = 0.0             # service start (>= t_formed)
    t_finish: float = 0.0
    reason: str = "direct"           # what flushed it: size|window|drain|direct

    @property
    def size(self) -> int:
        return len(self.requests)


@dataclass
class ServiceLine:
    """One logical device's free-at horizon; work serialises behind it."""
    free_at: float = 0.0

    def reserve(self, t: float, dur: float) -> tuple[float, float]:
        """Claim ``dur`` seconds starting no earlier than ``t``."""
        start = max(t, self.free_at)
        finish = start + dur
        self.free_at = finish
        return start, finish

    def backlog(self, now: float) -> float:
        """Seconds of already-reserved work still ahead of ``now``."""
        return max(self.free_at - now, 0.0)

    def reset(self) -> None:
        self.free_at = 0.0


@dataclass
class BatchQueue:
    """Window/size flush policy (no service model).

    ``submit``/``poll``/``drain`` return formed ``Batch``es with
    ``t_formed`` set and service times zeroed — callers attach timing
    (e.g. reserve a ``ServiceLine`` for a modelled or measured step).
    ``queue_window_s <= 0`` disables timeout flushes entirely (flush
    on size or drain only — the live adapters' default).
    """
    max_batch_size: int = 32
    queue_window_s: float = 0.01
    preferred_sizes: tuple = ()
    queue: list[Request] = field(default_factory=list)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def fill(self) -> float:
        return len(self.queue) / max(self.max_batch_size, 1)

    def submit(self, req: Request, now: float) -> list[Batch]:
        """Enqueue; returns any groups formed by this arrival (expired
        windows first, then a full-size flush)."""
        formed = self.poll(now)
        self.queue.append(req)
        if len(self.queue) >= self.max_batch_size:
            formed.extend(self._form(now, full=True, reason="size"))
        return formed

    def poll(self, now: float) -> list[Batch]:
        """Form batches whose queue window expired before ``now``."""
        out = []
        while self.queue and self.queue_window_s > 0:
            deadline = self.queue[0].arrival_s + self.queue_window_s
            if deadline <= now:
                out.extend(self._form(deadline, full=False,
                                      reason="window"))
            else:
                break
        return out

    def drain(self, now: float) -> list[Batch]:
        out = []
        while self.queue:
            out.extend(self._form(max(now, self.queue[0].arrival_s
                                      + self.queue_window_s), full=False,
                                  reason="drain"))
        return out

    def cancel(self, pred=None) -> list[Request]:
        """Remove queued requests matching ``pred`` (all when ``pred``
        is None) WITHOUT forming batches — the fault path: a crash
        strands the whole queue, deadline shedding removes only the
        expired.  Returns the removed requests in arrival order."""
        if pred is None:
            removed, self.queue[:] = list(self.queue), []
            return removed
        removed = [r for r in self.queue if pred(r)]
        if removed:
            self.queue[:] = [r for r in self.queue if not pred(r)]
        return removed

    def reset(self) -> None:
        self.queue.clear()

    def _form(self, t: float, *, full: bool,
              reason: str = "window") -> list[Batch]:
        n = min(len(self.queue), self.max_batch_size)
        if not full and self.preferred_sizes and n < self.max_batch_size:
            # round down to a preferred size when flushing on timeout;
            # the sub-preferred remainder stays queued (stragglers
            # re-flush in arrival order on the next poll)
            pref = [p for p in self.preferred_sizes if p <= n]
            if pref:
                n = pref[-1]
        reqs, self.queue = self.queue[:n], self.queue[n:]
        return [Batch(reqs, t_formed=t, reason=reason)]


@dataclass
class DirectPath:
    latency: LatencyModel
    line: ServiceLine = field(default_factory=ServiceLine)

    def serve(self, req: Request, now: float) -> Batch:
        start, finish = self.line.reserve(now, self.latency.step_time(1))
        return Batch([req], t_formed=now, t_start=start, t_finish=finish)

    def backlog(self, now: float) -> float:
        return self.line.backlog(now)

    def reset(self) -> None:
        self.line.reset()

    def busy_time(self) -> float:
        return 0.0                   # accounted per-batch by the caller


class DynamicBatcher:
    """``BatchQueue`` + ``ServiceLine`` + a latency model: the Triton
    analogue.  The queue/window config lives on ``self.window`` and
    the free-at horizon on ``self.line`` — this class only binds them
    to a modelled service time."""

    def __init__(self, latency: LatencyModel, max_batch_size: int = 32,
                 queue_window_s: float = 0.01,
                 preferred_sizes: tuple = (4, 8, 16, 32),
                 line: ServiceLine | None = None):
        self.latency = latency
        self.window = BatchQueue(max_batch_size=max_batch_size,
                                 queue_window_s=queue_window_s,
                                 preferred_sizes=preferred_sizes)
        self.line = line if line is not None else ServiceLine()

    # -- read views over the cores ------------------------------------------
    @property
    def queue(self) -> list[Request]:
        return self.window.queue

    @property
    def queue_depth(self) -> int:
        return self.window.queue_depth

    @property
    def fill(self) -> float:
        return self.window.fill

    # -- scheduling ----------------------------------------------------------
    def submit(self, req: Request, now: float) -> list[Batch]:
        """Enqueue; returns any batches flushed by this arrival."""
        return [self._serve(b) for b in self.window.submit(req, now)]

    def poll(self, now: float) -> list[Batch]:
        """Flush batches whose queue window expired before ``now``."""
        return [self._serve(b) for b in self.window.poll(now)]

    def drain(self, now: float) -> list[Batch]:
        return [self._serve(b) for b in self.window.drain(now)]

    def backlog(self, now: float) -> float:
        """Seconds of committed + queued work: the free-at horizon plus
        one modelled step over everything still queued."""
        b = self.line.backlog(now)
        if self.window.queue:
            b += self.latency.step_time(len(self.window.queue))
        return b

    def cancel(self, pred=None) -> list[Request]:
        """Remove queued (not yet batched) requests; see
        :meth:`BatchQueue.cancel`."""
        return self.window.cancel(pred)

    def reset(self) -> None:
        self.window.reset()
        self.line.reset()

    def _serve(self, b: Batch) -> Batch:
        b.t_start, b.t_finish = self.line.reserve(
            b.t_formed, self.latency.step_time(b.size))
        return b
