"""Fleet scenario suite — traffic shapes that stress the routing and
scaling decisions, built on ``serving.workload``'s exact thinning
sampler (``nonhomogeneous_arrivals``).

Each scenario function returns a :class:`Scenario`: the request trace (with
labels, per-request entropy hints, and tenant metadata), plus the
precomputed :class:`~repro_torch.serving.simulator.Oracle` the virtual-time
replicas execute against.  Deterministic per seed.

  - ``flash_crowd``          steady base rate with one sudden sustained
                             spike — the classic scale-up test and the
                             headline ``--fleet`` demo.
  - ``diurnal``              sinusoidal day/night load; deep troughs
                             are where the autoscaler's drain pays.
  - ``multi_tenant``         a Poisson mix of tenants with different
                             SLOs (``metadata['slo_s']``) — the
                             energy-aware router parks latency-tolerant
                             tenants in deeper, cheaper basins.
  - ``low_confidence_flood`` adversarial: a window of junk traffic
                             whose proxy entropy is pinned high and
                             whose proxy answers are coin flips —
                             admission controllers must spend energy or
                             accuracy, never both saved.

Two loaders extend the same surface beyond the synthetic scenarios:
:func:`from_trace` replays a recorded arrival/entropy trace (JSON or
CSV) as a ``Scenario``, and :func:`with_payloads` attaches real
per-request payloads (token ids) so a scenario's traffic shape can
drive the LIVE engines (``repro_torch.fleet.pool.build_live_fleet``) instead
of the oracle-backed virtual-time replicas.
"""
from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.landscape import LatencyModel
from repro_torch.serving.api import InferRequest
from repro_torch.serving.simulator import Oracle
from repro_torch.serving.workload import nonhomogeneous_arrivals


@dataclass
class Scenario:
    name: str
    requests: list
    oracle: Oracle
    description: str = ""
    slo_s: float = 0.25

    @property
    def n(self) -> int:
        return len(self.requests)

    @property
    def span_s(self) -> float:
        if not self.requests:
            return 0.0
        return (self.requests[-1].arrival_s
                - self.requests[0].arrival_s)


def _oracle(n: int, rng, *, proxy_acc: float = 0.85,
            entropy=None) -> Oracle:
    labels = rng.integers(0, 2, n)
    full = labels.copy()
    flip = rng.random(n) < (1 - proxy_acc)
    proxy = np.where(flip, 1 - labels, labels)
    ent = (rng.uniform(0.0, 0.7, n) if entropy is None
           else np.asarray(entropy, float))
    return Oracle(full_pred=full, proxy_pred=proxy, entropy=ent,
                  labels=labels,
                  proxy_latency=LatencyModel(0.0002, 0.0))


def _requests(arrivals, oracle: Oracle, *, metadata=None):
    out = []
    for i, a in enumerate(arrivals):
        out.append(InferRequest(
            rid=i, arrival_s=a.arrival_s,
            label=int(oracle.labels[i]),
            entropy_hint=float(oracle.entropy[i]),
            metadata=dict(metadata[i]) if metadata is not None else {}))
    return out


def steady(n: int = 2000, *, qps: float = 80.0,
           seed: int = 0) -> Scenario:
    """Constant-rate Poisson traffic — the control scenario and the
    load axis the QPS boundary sweep (the JAX package's
    ``benchmarks/fleet_boundary.py``) walks."""
    rng = np.random.default_rng(seed + 5)   # decouple from arrival draws
    arrivals = nonhomogeneous_arrivals(n, lambda t: qps, qps, seed=seed)
    oracle = _oracle(n, rng)
    return Scenario(
        name="steady", requests=_requests(arrivals, oracle),
        oracle=oracle, description=f"{qps} qps Poisson")


def flash_crowd(n: int = 2000, *, qps: float = 40.0,
                flash_x: float = 10.0, flash_at_s: float = 10.0,
                flash_len_s: float = 5.0, seed: int = 0) -> Scenario:
    """Base rate ``qps`` with a ``flash_x``-times spike of
    ``flash_len_s`` seconds starting at ``flash_at_s``."""
    flash_qps = qps * flash_x

    def rate(t: float) -> float:
        return (flash_qps if flash_at_s <= t < flash_at_s + flash_len_s
                else qps)

    rng = np.random.default_rng(seed + 1)
    arrivals = nonhomogeneous_arrivals(n, rate, flash_qps, seed=seed)
    oracle = _oracle(n, rng)
    return Scenario(
        name="flash-crowd", requests=_requests(arrivals, oracle),
        oracle=oracle,
        description=(f"{qps} qps base, x{flash_x} flash at "
                     f"t={flash_at_s}s for {flash_len_s}s"))


def diurnal(n: int = 2000, *, qps: float = 20.0, peak_x: float = 8.0,
            period_s: float = 40.0, seed: int = 0) -> Scenario:
    """Sinusoidal day/night cycle between ``qps`` and ``qps*peak_x``."""
    peak = qps * peak_x

    def rate(t: float) -> float:
        phase = (1 - math.cos(2 * math.pi * t / period_s)) / 2
        return qps + (peak - qps) * phase

    rng = np.random.default_rng(seed + 2)
    arrivals = nonhomogeneous_arrivals(n, rate, peak, seed=seed)
    oracle = _oracle(n, rng)
    return Scenario(
        name="diurnal", requests=_requests(arrivals, oracle),
        oracle=oracle,
        description=(f"{qps}..{peak} qps sinusoid, "
                     f"period {period_s}s"))


DEFAULT_TENANTS = (
    # (name, traffic share, SLO seconds)
    ("interactive", 0.3, 0.10),
    ("standard", 0.5, 0.30),
    ("batch", 0.2, 2.00),
)


def multi_tenant(n: int = 2000, *, qps: float = 80.0,
                 tenants=DEFAULT_TENANTS, seed: int = 0) -> Scenario:
    """A steady Poisson mix of tenants with different latency SLOs;
    each request carries ``metadata={'tenant', 'slo_s'}``."""
    shares = np.array([t[1] for t in tenants], float)
    if not math.isclose(float(shares.sum()), 1.0, rel_tol=1e-6):
        raise ValueError(f"tenant shares must sum to 1, got "
                         f"{shares.sum():.4f}")
    rng = np.random.default_rng(seed + 3)
    arrivals = nonhomogeneous_arrivals(n, lambda t: qps, qps, seed=seed)
    which = rng.choice(len(tenants), size=n, p=shares)
    meta = [{"tenant": tenants[w][0], "slo_s": tenants[w][2]}
            for w in which]
    oracle = _oracle(n, rng)
    return Scenario(
        name="multi-tenant",
        requests=_requests(arrivals, oracle, metadata=meta),
        oracle=oracle,
        description=(f"{qps} qps, tenants "
                     + "/".join(t[0] for t in tenants)))


def low_confidence_flood(n: int = 2000, *, qps: float = 80.0,
                         flood_at_s: float = 8.0,
                         flood_len_s: float = 6.0, flood_x: float = 4.0,
                         seed: int = 0) -> Scenario:
    """Adversarial junk-traffic window: arrival rate jumps ``flood_x``
    times AND the flood's requests carry maximal proxy entropy with
    coin-flip proxy answers.  An admission policy that skips on high
    L(x) answers the flood from a 50%-accurate proxy; one that admits
    it burns full-model energy on junk — the scenario makes that
    trade-off visible instead of hiding it in an average."""
    flood_qps = qps * flood_x

    def rate(t: float) -> float:
        return (flood_qps if flood_at_s <= t < flood_at_s + flood_len_s
                else qps)

    rng = np.random.default_rng(seed + 4)
    arrivals = nonhomogeneous_arrivals(n, rate, flood_qps, seed=seed)
    in_flood = np.array(
        [flood_at_s <= a.arrival_s < flood_at_s + flood_len_s
         for a in arrivals])
    ln2 = float(np.log(2.0))
    entropy = np.where(in_flood,
                       rng.uniform(0.9 * ln2, ln2, n),
                       rng.uniform(0.0, 0.5, n))
    labels = rng.integers(0, 2, n)
    full = labels.copy()
    # normal traffic: decent proxy; flood: coin-flip proxy
    flip = np.where(in_flood, rng.random(n) < 0.5,
                    rng.random(n) < 0.15)
    proxy = np.where(flip, 1 - labels, labels)
    oracle = Oracle(full_pred=full, proxy_pred=proxy, entropy=entropy,
                    labels=labels,
                    proxy_latency=LatencyModel(0.0002, 0.0))
    meta = [{"flood": bool(f)} for f in in_flood]
    return Scenario(
        name="low-confidence-flood",
        requests=_requests(arrivals, oracle, metadata=meta),
        oracle=oracle,
        description=(f"{qps} qps, x{flood_x} high-entropy flood at "
                     f"t={flood_at_s}s for {flood_len_s}s"))


# ---------------------------------------------------------------------------
# trace replay + live payloads
# ---------------------------------------------------------------------------

_TRACE_FIELDS = ("arrival_s", "entropy", "label", "tenant", "slo_s")


def _require_binary_labels(labels: np.ndarray, where: str) -> None:
    """The whole scenario/oracle surface is a two-class task (synthetic
    proxies are derived as ``1 - label`` flips) — reject anything else
    at the boundary instead of silently producing invalid predictions
    and garbage accuracy."""
    bad = np.setdiff1d(np.unique(labels), (0, 1))
    if bad.size:
        raise ValueError(
            f"{where}: labels must be binary (0/1) — the oracle "
            f"synthesises proxy predictions as label flips — got "
            f"values {bad.tolist()}")


def _trace_records(path: str) -> tuple[list[dict], dict]:
    """Read trace records from JSON (a list, or ``{"name":..,
    "slo_s":.., "requests": [...]}``) or CSV (header row; ``arrival_s``
    required, the rest optional)."""
    ext = os.path.splitext(path)[1].lower()
    meta: dict = {}
    if ext == ".csv":
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    else:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            rows = doc.get("requests", [])
            meta = {k: v for k, v in doc.items() if k != "requests"}
        else:
            rows = doc
    if not rows:
        raise ValueError(f"trace {path!r} contains no requests")
    out = []
    for i, r in enumerate(rows):
        if "arrival_s" not in r or r["arrival_s"] in ("", None):
            raise ValueError(
                f"trace {path!r} record {i} has no arrival_s: {r}")
        rec = {"arrival_s": float(r["arrival_s"])}
        for k in _TRACE_FIELDS[1:]:
            v = r.get(k)
            if v not in ("", None):
                rec[k] = (str(v) if k == "tenant" else float(v))
        out.append(rec)
    return out, meta


def from_trace(path: str, *, name: str | None = None,
               proxy_acc: float = 0.85, seed: int = 0,
               slo_s: float | None = None) -> Scenario:
    """Replay a recorded arrival/entropy trace through the same
    :class:`Scenario` surface the synthetic scenarios fill, so
    production traces and the paper's workloads run under identical
    routing/scaling/admission policies.

    Accepts JSON (a list of records, or ``{"name", "slo_s",
    "requests": [...]}``) and CSV (header row).  Per record only
    ``arrival_s`` is required; ``entropy``, ``label``, ``tenant`` and
    ``slo_s`` are honoured when present and drawn deterministically
    (per ``seed``, like the synthetic scenarios) when absent.  Arrivals
    are sorted; the synthesised ``Oracle`` keeps ``proxy_acc`` proxy
    agreement against the (recorded or drawn) labels.
    """
    records, meta = _trace_records(path)
    records.sort(key=lambda r: r["arrival_s"])
    n = len(records)
    rng = np.random.default_rng(seed + 7)

    labels = np.array([int(r["label"]) if "label" in r
                       else int(rng.integers(0, 2)) for r in records])
    _require_binary_labels(labels, f"trace {path!r}")
    ent = np.array([float(r["entropy"]) if "entropy" in r
                    else float(rng.uniform(0.0, 0.7)) for r in records])
    flip = rng.random(n) < (1 - proxy_acc)
    proxy = np.where(flip, 1 - labels, labels)
    oracle = Oracle(full_pred=labels.copy(), proxy_pred=proxy,
                    entropy=ent, labels=labels,
                    proxy_latency=LatencyModel(0.0002, 0.0))

    requests = []
    for i, r in enumerate(records):
        md = {k: r[k] for k in ("tenant", "slo_s") if k in r}
        requests.append(InferRequest(
            rid=i, arrival_s=r["arrival_s"], label=int(labels[i]),
            entropy_hint=float(ent[i]), metadata=md))
    sc_name = name or meta.get("name") or os.path.splitext(
        os.path.basename(path))[0]
    return Scenario(
        name=str(sc_name), requests=requests, oracle=oracle,
        description=f"trace replay of {os.path.basename(path)} "
                    f"({n} requests)",
        slo_s=float(slo_s if slo_s is not None
                    else meta.get("slo_s", 0.25)))


def with_payloads(scenario: Scenario, payloads,
                  labels=None) -> Scenario:
    """Clone a scenario's trace with real per-request payloads (token
    ids) so the same arrival/entropy shape can drive LIVE engines.
    ``labels`` (optional) replace the synthetic labels with the
    dataset's, so fleet accuracy measures the real model — the oracle
    is REBUILT onto the new labels (same per-request proxy-flip
    pattern, same entropies), so running the returned scenario through
    virtual-time replicas stays self-consistent too."""
    if len(payloads) < scenario.n:
        raise ValueError(
            f"need >= {scenario.n} payloads for scenario "
            f"{scenario.name!r}, got {len(payloads)}")
    oracle = scenario.oracle
    if labels is not None:
        if len(labels) < scenario.n:
            raise ValueError(
                f"need >= {scenario.n} labels for scenario "
                f"{scenario.name!r}, got {len(labels)}")
        new = np.asarray(labels[:scenario.n]).astype(
            oracle.labels.dtype if oracle.labels is not None else int)
        _require_binary_labels(new, f"with_payloads({scenario.name!r})")
        # carry the scenario's proxy-disagreement pattern onto the new
        # labels (a flood's coin-flip proxy stays a coin flip)
        flip = (oracle.proxy_pred != oracle.labels
                if oracle.labels is not None
                else np.zeros(scenario.n, bool))
        oracle = Oracle(full_pred=new.copy(),
                        proxy_pred=np.where(flip, 1 - new, new),
                        entropy=oracle.entropy.copy(), labels=new,
                        proxy_latency=oracle.proxy_latency)
    requests = [
        replace(r, payload=payloads[i],
                label=(int(labels[i]) if labels is not None
                       else r.label),
                metadata=dict(r.metadata))
        for i, r in enumerate(scenario.requests)]
    return Scenario(
        name=scenario.name, requests=requests, oracle=oracle,
        description=f"{scenario.description} (live payloads)",
        slo_s=scenario.slo_s)


def with_deadline(scenario: Scenario,
                  deadline_s: float | None) -> Scenario:
    """Clone a scenario with a per-request completion deadline
    (``InferRequest.deadline_s``).  Requests still queued past
    ``arrival_s + deadline_s`` are shed as rejections-with-reason by
    the serving/fleet layers (``repro_torch.faults``); ``None`` clears any
    deadline.  Traffic shape, oracle, and rids are untouched."""
    requests = [replace(r, deadline_s=deadline_s,
                        metadata=dict(r.metadata))
                for r in scenario.requests]
    return Scenario(
        name=scenario.name, requests=requests, oracle=scenario.oracle,
        description=(scenario.description
                     + (f" (deadline {deadline_s}s)"
                        if deadline_s is not None else "")),
        slo_s=scenario.slo_s)


# -- generate-kind scenarios (disaggregated serving) ------------------------
# These carry token payloads and ``kind="generate"`` and live in their
# OWN registry: SCENARIOS feeds classifier fleets (the JAX package's
# benchmarks/fleet_live.py iterates it over live classifier replicas), so
# generation traffic must never leak into it.

def _generate_requests(arrivals, rng, oracle: Oracle, *, vocab: int,
                       prompt_lens, max_news):
    out = []
    for i, a in enumerate(arrivals):
        out.append(InferRequest(
            rid=i, arrival_s=a.arrival_s,
            payload=rng.integers(0, vocab,
                                 int(prompt_lens[i])).astype(np.int32),
            kind="generate", max_new=int(max_news[i]),
            entropy_hint=float(oracle.entropy[i])))
    return out


def prompt_burst(n: int = 64, *, qps: float = 20.0,
                 burst_x: float = 6.0, burst_at_s: float = 1.0,
                 burst_len_s: float = 1.0, short_prompt: int = 8,
                 long_prompt: int = 24, max_new: int = 4,
                 vocab: int = 512, seed: int = 0) -> Scenario:
    """PREFILL-side stress: a sudden sustained burst of long-prompt
    generation arrivals.  Short prompts outside the window, long ones
    inside — disaggregation should scale the prefill pool through the
    burst while the decode pool stays put."""
    burst_qps = qps * burst_x

    def rate(t: float) -> float:
        return (burst_qps if burst_at_s <= t < burst_at_s + burst_len_s
                else qps)

    arrivals = nonhomogeneous_arrivals(n, rate, burst_qps, seed=seed)
    rng = np.random.default_rng(seed + 11)
    oracle = _oracle(n, rng)
    plens = [long_prompt
             if burst_at_s <= a.arrival_s < burst_at_s + burst_len_s
             else short_prompt for a in arrivals]
    reqs = _generate_requests(arrivals, rng, oracle, vocab=vocab,
                              prompt_lens=plens,
                              max_news=[max_new] * n)
    return Scenario(
        name="prompt-burst", requests=reqs, oracle=oracle,
        description=(f"{qps} qps generate, x{burst_x} long-prompt "
                     f"({long_prompt} tok) burst at t={burst_at_s}s "
                     f"for {burst_len_s}s"))


def long_decode(n: int = 64, *, qps: float = 20.0,
                long_frac: float = 0.3, prompt: int = 8,
                short_new: int = 4, long_new: int = 24,
                vocab: int = 512, seed: int = 0) -> Scenario:
    """DECODE-side stress: steady short prompts, but a ``long_frac``
    fraction of requests decode ``long_new`` tokens — slot/block
    residency (not prefill compute) becomes the scarce resource and
    decode-pool pressure should drive scaling."""
    arrivals = nonhomogeneous_arrivals(n, lambda t: qps, qps,
                                       seed=seed)
    rng = np.random.default_rng(seed + 13)
    oracle = _oracle(n, rng)
    news = [long_new if rng.random() < long_frac else short_new
            for _ in range(n)]
    reqs = _generate_requests(arrivals, rng, oracle, vocab=vocab,
                              prompt_lens=[prompt] * n,
                              max_news=news)
    return Scenario(
        name="long-decode", requests=reqs, oracle=oracle,
        description=(f"{qps} qps generate, {long_frac:.0%} of "
                     f"requests decode {long_new} tokens"))


SCENARIOS = {
    "steady": steady,
    "flash-crowd": flash_crowd,
    "diurnal": diurnal,
    "multi-tenant": multi_tenant,
    "low-confidence-flood": low_confidence_flood,
}

GENERATE_SCENARIOS = {
    "prompt-burst": prompt_burst,
    "long-decode": long_decode,
}


def make_scenario(name: str, n: int = 2000, *, qps: float | None = None,
                  seed: int = 0, **kw) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; known: "
                         f"{sorted(SCENARIOS)}")
    if qps is not None:
        kw["qps"] = qps
    return SCENARIOS[name](n, seed=seed, **kw)


def make_generate_scenario(name: str, n: int = 64, *,
                           qps: float | None = None, seed: int = 0,
                           **kw) -> Scenario:
    if name not in GENERATE_SCENARIOS:
        raise ValueError(f"unknown generate scenario {name!r}; known: "
                         f"{sorted(GENERATE_SCENARIOS)}")
    if qps is not None:
        kw["qps"] = qps
    return GENERATE_SCENARIOS[name](n, seed=seed, **kw)
