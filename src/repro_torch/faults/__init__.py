"""``repro_torch.faults`` — seeded, deterministic fault injection and
recovery across the serving/fleet/disagg stack.

The green-ML-serving literature treats degradation and recovery as
first-class architectural decisions with direct energy cost: retried
and wasted work is burned joules, so graceful degradation is itself an
energy lever the closed-loop controller should own.  This package
makes failure a *scheduled, reproducible* input rather than an
accident:

  - :mod:`plan`     — :class:`FaultPlan` (scripted or seeded-random
                      fault schedules on the virtual clock) and the
                      :class:`FaultInjector` that drains due events.
  - :mod:`health`   — the replica health state machine
                      (HEALTHY / DEGRADED / FAILED / RECOVERING).
  - :mod:`retry`    — bounded retry budgets with virtual-time
                      exponential backoff.
  - :mod:`brownout` — sustained failure pressure tightens τ(t) so
                      admission sheds load before queues melt: the
                      first-acceptable-basin rule applied to degraded
                      capacity.
  - :mod:`chaos`    — the chaos scenario suite (traffic trace +
                      fault plan + deadlines) behind one registry.

Every fault, retry, expiry, and recovery lands as telemetry
events and metrics (``fleet_failures`` / ``fleet_retries`` /
``fleet_expired`` / ``fleet_wasted_j``); the JAX package's
``benchmarks/chaos_recovery.py`` turns recovery into a tracked quantity
(``BENCH_chaos.json``).
"""
from repro_torch.faults.brownout import BrownoutController
from repro_torch.faults.chaos import (CHAOS_SCENARIOS, ChaosScenario,
                                      make_chaos, with_deadlines)
from repro_torch.faults.health import (DEGRADED, FAILED, HEALTHY, RECOVERING,
                                       HealthState)
from repro_torch.faults.plan import (FAULT_KINDS, FaultEvent, FaultInjector,
                                     FaultPlan)
from repro_torch.faults.retry import RetryPolicy

__all__ = [
    "FAULT_KINDS", "FaultEvent", "FaultPlan", "FaultInjector",
    "HEALTHY", "DEGRADED", "FAILED", "RECOVERING", "HealthState",
    "RetryPolicy", "BrownoutController",
    "ChaosScenario", "CHAOS_SCENARIOS", "make_chaos", "with_deadlines",
]
