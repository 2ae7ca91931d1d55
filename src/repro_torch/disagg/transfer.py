"""KV hand-off between the prefill and decode pools, ported from
``repro.disagg.transfer`` (host arithmetic only).

Disaggregation is not free: every admitted request ships its prompt
KV across the phase boundary (NVLink / PCIe / network, depending on
topology).  ``TransferQueue`` models that link as one serialised
``ServiceLine`` — per-transfer latency is a fixed base cost plus
``bytes / bandwidth``, transfers queue behind each other, and the
line's backlog is the "transfer pressure" term the phase-aware router
sees.  Byte counts come from :meth:`PrefillEngine.kv_bytes` — the
LOGICAL prompt-KV payload, not the padded physical row extent.  On one
card the hand-off itself is the decode session's indexed write of the
rows into its pool; the link is the model of what a fleet of devices
would pay for it."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.disagg.engine import PrefillResult
from repro_torch.serving.batcher import ServiceLine


@dataclass
class Transfer:
    """One in-flight KV hand-off: who, how many bytes, when it was
    sent and when it lands on the decode side."""
    result: PrefillResult
    send_t: float
    arrive_t: float
    n_bytes: int
    dst: str | None = None
    start_t: float = 0.0             # when the link actually picked it up


@dataclass
class TransferQueue:
    """Serialised phase-boundary link with a bandwidth/latency model.

    ``send`` reserves the link (transfers queue FIFO behind each
    other), ``deliver`` releases everything that has landed by
    ``now``, ``pressure`` is the link's backlog-seconds — the same
    unit every other pressure signal in the stack uses."""
    gbps: float = 16.0                   # link bandwidth, GB/s
    base_latency_s: float = 0.0005       # per-transfer fixed cost

    _line: ServiceLine = field(default_factory=ServiceLine, init=False)
    _inflight: list[Transfer] = field(default_factory=list, init=False)
    total_bytes: int = field(default=0, init=False)
    n_transfers: int = field(default=0, init=False)
    # fault state (repro_torch.faults): link-flap outage + bandwidth collapse
    outage_until: float = field(default=0.0, init=False)
    n_dropped: int = field(default=0, init=False)
    slow_factor: float = field(default=1.0, init=False)
    slow_until: float = field(default=0.0, init=False)

    def send(self, pr: PrefillResult, now: float,
             dst: str | None = None) -> Transfer:
        t0 = max(now, self.outage_until)   # nothing moves during outage
        dur = self.base_latency_s + pr.kv_bytes / (self.gbps * 1e9)
        if t0 < self.slow_until and self.slow_factor > 1.0:
            dur *= self.slow_factor        # bandwidth collapse window
        start, arrive = self._line.reserve(t0, dur)
        t = Transfer(result=pr, send_t=now, arrive_t=arrive,
                     n_bytes=pr.kv_bytes, dst=dst, start_t=start)
        self._inflight.append(t)
        self.total_bytes += pr.kv_bytes
        self.n_transfers += 1
        return t

    def deliver(self, now: float) -> list[Transfer]:
        """Pop (in arrival order) every transfer that landed by now."""
        done = [t for t in self._inflight if t.arrive_t <= now]
        self._inflight = [t for t in self._inflight
                          if t.arrive_t > now]
        return sorted(done, key=lambda t: t.arrive_t)

    def deliver_all(self) -> list[Transfer]:
        done, self._inflight = self._inflight, []
        return sorted(done, key=lambda t: t.arrive_t)

    @property
    def inflight(self) -> list[Transfer]:
        return list(self._inflight)

    # -- faults (repro_torch.faults) -----------------------------------------
    def flap(self, now: float, duration_s: float) -> list[Transfer]:
        """Link outage: every hand-off still in flight past ``now`` is
        LOST (the decode side never sees it) and the link is down
        until ``now + duration_s``.  Returns the dropped transfers so
        the caller can retransmit or re-prefill them."""
        lost = [t for t in self._inflight if t.arrive_t > now]
        self._inflight = [t for t in self._inflight
                          if t.arrive_t <= now]
        self.n_dropped += len(lost)
        self.outage_until = max(self.outage_until, now + duration_s)
        # the link's horizon restarts after the outage
        self._line.free_at = max(self._line.free_at, self.outage_until)
        return lost

    def drop_to(self, dst: str) -> list[Transfer]:
        """Drop every in-flight hand-off addressed to ``dst`` (its
        decode worker crashed; the KV has nowhere to land).  Returns
        the dropped transfers for retransmission elsewhere."""
        lost = [t for t in self._inflight if t.dst == dst]
        if lost:
            self._inflight = [t for t in self._inflight
                              if t.dst != dst]
            self.n_dropped += len(lost)
        return lost

    def collapse(self, now: float, duration_s: float,
                 factor: float) -> None:
        """Bandwidth collapse: transfers sent before ``now +
        duration_s`` take ``factor``x longer (nothing is lost)."""
        self.slow_factor = max(1.0, float(factor))
        self.slow_until = max(self.slow_until, now + duration_s)

    def pressure(self, now: float) -> float:
        return self._line.backlog(now)

    def reset(self) -> None:
        self._line.reset()
        self._inflight.clear()
        self.total_bytes = 0
        self.n_transfers = 0
        self.outage_until = 0.0
        self.n_dropped = 0
        self.slow_factor = 1.0
        self.slow_until = 0.0

    def stats(self) -> dict:
        return {"n_transfers": self.n_transfers,
                "total_bytes": self.total_bytes,
                "n_dropped": self.n_dropped,
                "gbps": self.gbps,
                "base_latency_s": self.base_latency_s}
