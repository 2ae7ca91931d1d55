"""Bounded retry budgets with virtual-time exponential backoff.

Stranded work (crashed replica, dropped transfer, no routable
replica) is requeued at ``now + delay(attempt)`` until the budget is
exhausted, at which point the request terminates as a
rejection-with-reason — never a hang, and never an unbounded retry
storm re-burning joules on a melting fleet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class RetryPolicy:
    """Exponential backoff: ``min(base * mult**(attempt-1), max)``."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 1.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-indexed)."""
        a = max(1, int(attempt))
        d = self.backoff_base_s * self.backoff_mult ** (a - 1)
        return float(min(d, self.backoff_max_s))

    def allows(self, attempt: int) -> bool:
        """True if retry number ``attempt`` is within budget."""
        return int(attempt) <= self.max_retries
