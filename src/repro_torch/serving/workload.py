"""Request model + synthetic arrival processes.

The paper's HTTP front-ends (FastAPI endpoints, Triton gRPC) become
in-process request streams: Poisson for steady traffic, on/off bursts
for the "bursty QPS" regime where Triton-style dynamic batching wins,
and a general rate-function sampler (``nonhomogeneous_arrivals``) that
the fleet scenario suite (``repro.fleet.scenarios``) builds its
diurnal / flash-crowd / multi-tenant traces on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np


@dataclass
class Request:
    rid: int
    arrival_s: float
    payload: Any = None            # token ids / image / feature index
    label: int | None = None       # for accuracy accounting


def poisson_arrivals(n: int, rate_qps: float, *, seed: int = 0,
                     payloads=None, labels=None) -> list[Request]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    times = np.cumsum(gaps)
    return _mk(times, payloads, labels)


def nonhomogeneous_arrivals(n: int, rate_fn: Callable[[float], float],
                            rate_max: float, *, seed: int = 0, t0: float = 0.0,
                            payloads=None, labels=None,
                            max_candidates: int | None = None
                            ) -> list[Request]:
    """Exact non-homogeneous Poisson sampling by thinning (Lewis &
    Shedler): draw candidate events at the envelope rate ``rate_max``
    and keep each with probability ``rate_fn(t) / rate_max``.  Unlike
    naive gap sampling, a long low-rate gap can never jump over a
    short high-rate window — the envelope sees every window.

    ``max_candidates`` (default ``max(10_000, 1000 * n)``) bounds the
    thinning loop: a rate function that decays to ~0 before ``n``
    arrivals accumulate raises instead of spinning forever.
    """
    if rate_max <= 0:
        raise ValueError(f"rate_max must be positive, got {rate_max}")
    if max_candidates is None:
        max_candidates = max(10_000, 1000 * n)
    rng = np.random.default_rng(seed)
    times, t = [], t0
    for _ in range(max_candidates):
        if len(times) >= n:
            break
        t += rng.exponential(1.0 / rate_max)
        r = float(rate_fn(t))
        if r > rate_max * (1 + 1e-9):
            raise ValueError(
                f"rate_fn({t:.4f})={r:.4f} exceeds the thinning envelope "
                f"rate_max={rate_max}")
        if rng.random() * rate_max <= r:
            times.append(t)
    if len(times) < n:
        raise RuntimeError(
            f"thinning stalled: {len(times)}/{n} arrivals after "
            f"{max_candidates} candidates — rate_fn is (near-)zero over "
            f"the sampled horizon (t reached {t:.4f})")
    return _mk(np.asarray(times), payloads, labels)


def bursty_arrivals(n: int, base_qps: float, burst_qps: float, *,
                    burst_every_s: float = 2.0, burst_len_s: float = 0.5,
                    seed: int = 0, payloads=None, labels=None
                    ) -> list[Request]:
    """On/off modulated Poisson: base rate with periodic bursts.

    Sampled by thinning so bursts are never skipped: the old
    gap-at-the-gap's-start sampler let one long base-rate gap jump
    clean over an entire burst window, silently thinning exactly the
    dense traffic the dual-path benchmarks depend on.
    """
    if burst_qps < base_qps:
        raise ValueError(
            f"burst windows must be denser than the base rate: "
            f"burst_qps={burst_qps} < base_qps={base_qps}")
    if not 0 < burst_len_s <= burst_every_s:
        raise ValueError(
            f"burst_len_s={burst_len_s} must be in (0, "
            f"burst_every_s={burst_every_s}]")

    def rate(t: float) -> float:
        return (burst_qps if (t % burst_every_s) < burst_len_s
                else base_qps)

    return nonhomogeneous_arrivals(n, rate, burst_qps, seed=seed,
                                   payloads=payloads, labels=labels)


def closed_loop_arrivals(n: int, *, think_s: float = 0.0,
                         payloads=None, labels=None) -> list[Request]:
    """Back-to-back (offline/batch) arrivals — the ablation's regime."""
    times = np.arange(n) * think_s
    return _mk(times, payloads, labels)


def _mk(times, payloads, labels) -> list[Request]:
    out = []
    for i, t in enumerate(times):
        out.append(Request(
            rid=i, arrival_s=float(t),
            payload=None if payloads is None else payloads[i],
            label=None if labels is None else int(labels[i])))
    return out
