"""Fault plans: scripted or seeded-random fault schedules on the
virtual clock.

A :class:`FaultPlan` is an immutable, sorted list of
:class:`FaultEvent`\\ s.  Two constructions are supported:

  - :meth:`FaultPlan.scripted` — hand-written event lists for
    reproducible chaos scenarios and tests;
  - :meth:`FaultPlan.seeded` — a ``numpy`` PRNG draw keyed by an
    integer seed.  Identical seeds produce *byte-identical* schedules
    (``to_json`` is canonical), which the determinism property test
    asserts.

The :class:`FaultInjector` is the runtime half: simulators call
:meth:`FaultInjector.pop_due` as the virtual clock advances and apply
whatever events fall due.  The injector never touches replicas
itself — it is a schedule, not a policy — so the same plan drives the
fleet loop, the disagg loop, and the transfer micro-sim identically.
"""
from __future__ import annotations

import difflib
import hashlib
import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

# Fault taxonomy (docs/ARCHITECTURE.md §7).  Each kind maps onto one
# concrete failure mode of the stack:
#   crash     — replica/worker dies; in-flight and queued work lost.
#   degrade   — slow node; service times multiplied by `magnitude`.
#   link-flap — transfer link outage; in-flight KV handoffs dropped.
#   kv-spike  — KV-pool exhaustion; pressure bias added for a window.
FAULT_CRASH = "crash"
FAULT_DEGRADE = "degrade"
FAULT_LINK_FLAP = "link-flap"
FAULT_KV_SPIKE = "kv-spike"
FAULT_KINDS = (FAULT_CRASH, FAULT_DEGRADE, FAULT_LINK_FLAP, FAULT_KV_SPIKE)


def _unknown_fault_msg(kind: str) -> str:
    msg = f"unknown fault kind {kind!r}"
    close = difflib.get_close_matches(kind, FAULT_KINDS, n=1)
    if close:
        msg += f" — did you mean {close[0]!r}?"
    return msg + f" (known: {', '.join(FAULT_KINDS)})"


@dataclass(frozen=True, slots=True)
class FaultEvent:
    """One scheduled fault on the virtual clock.

    ``target`` names a replica/worker (``"direct-0"``) or a link
    (``"link"`` for transfer faults); an empty target means "let the
    injector's consumer pick" (e.g. round-robin over the pool).
    ``magnitude`` is kind-specific: service-time multiplier for
    ``degrade``, bandwidth-collapse factor for ``link-flap``, pressure
    bias (seconds) for ``kv-spike``; unused for ``crash``.
    """

    t: float
    kind: str
    target: str = ""
    duration_s: float = 0.5
    magnitude: float = 2.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(_unknown_fault_msg(self.kind))
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.duration_s < 0.0:
            raise ValueError(
                f"fault duration must be >= 0, got {self.duration_s}")

    def to_dict(self) -> dict:
        return {
            "t": round(float(self.t), 9),
            "kind": self.kind,
            "target": self.target,
            "duration_s": round(float(self.duration_s), 9),
            "magnitude": round(float(self.magnitude), 9),
        }


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted fault schedule."""

    events: tuple[FaultEvent, ...] = ()
    seed: int | None = None

    @classmethod
    def scripted(cls, events: Iterable[FaultEvent]) -> "FaultPlan":
        evs = tuple(sorted(events, key=lambda e: (e.t, e.kind, e.target)))
        return cls(events=evs, seed=None)

    @classmethod
    def seeded(
        cls,
        seed: int,
        targets: Sequence[str],
        horizon_s: float,
        *,
        n_events: int = 6,
        kinds: Sequence[str] = FAULT_KINDS,
        min_duration_s: float = 0.2,
        max_duration_s: float = 1.0,
    ) -> "FaultPlan":
        """Draw ``n_events`` faults uniformly over ``[0, horizon_s)``.

        The draw is a pure function of ``seed`` and the arguments —
        identical inputs produce byte-identical plans (see
        :meth:`to_json`).
        """
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(_unknown_fault_msg(k))
        if not targets:
            raise ValueError("seeded plan needs at least one target")
        rng = np.random.default_rng(int(seed))
        events = []
        for _ in range(int(n_events)):
            t = float(rng.uniform(0.0, horizon_s))
            kind = str(kinds[int(rng.integers(0, len(kinds)))])
            if kind == FAULT_LINK_FLAP:
                target = "link"
            else:
                target = str(targets[int(rng.integers(0, len(targets)))])
            dur = float(rng.uniform(min_duration_s, max_duration_s))
            mag = float(rng.uniform(1.5, 4.0))
            events.append(FaultEvent(
                t=t, kind=kind, target=target, duration_s=dur, magnitude=mag))
        evs = tuple(sorted(events, key=lambda e: (e.t, e.kind, e.target)))
        return cls(events=evs, seed=int(seed))

    def to_json(self) -> str:
        """Canonical compact serialization — byte-stable across runs."""
        doc = {
            "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    def signature(self) -> str:
        return hashlib.sha256(self.to_json().encode("utf-8")).hexdigest()

    @property
    def horizon(self) -> float:
        """Latest instant at which any fault is still in effect."""
        if not self.events:
            return 0.0
        return max(e.t + e.duration_s for e in self.events)


@dataclass
class FaultInjector:
    """Drains a :class:`FaultPlan` as the virtual clock advances."""

    plan: FaultPlan
    _cursor: int = field(default=0, init=False, repr=False)

    def reset(self) -> None:
        self._cursor = 0

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self.plan.events)

    def next_t(self) -> float | None:
        """Virtual time of the next undrained event, or ``None``."""
        if self.exhausted:
            return None
        return self.plan.events[self._cursor].t

    def pop_due(self, now: float) -> list[FaultEvent]:
        """Return (and consume) every event with ``t <= now``."""
        due: list[FaultEvent] = []
        evs = self.plan.events
        while self._cursor < len(evs) and evs[self._cursor].t <= now:
            due.append(evs[self._cursor])
            self._cursor += 1
        return due
