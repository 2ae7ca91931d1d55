"""Gated serving step — the controller on the device, ported from
``repro.serving.gated``.

One step per batch keeps the whole Appendix-A loop on the card with
static shapes, as the reference's jit does on the TPU:

  1. proxy pass (early-exit head) over the full batch;
  2. the CUDA entropy kernel -> L(x);
  3. vectorised J(x) vs tau -> admission mask;
  4. the ``capacity`` lowest-J admitted requests are GATHERED into a
     fixed-size bucket, the full model runs ONLY on that bucket
     (capacity/B of the FLOPs), results scatter back;
  5. everything else is answered by the proxy head
     ("skip or respond from cache").

The bucket is chosen with a STABLE descending sort: ``jax.lax.top_k``
keeps the lower index on a tie, ``torch.topk`` promises no order.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.energy import EnergyMeter
from repro_torch.kernels import ops as kops
from repro_torch.kernels.runtime import resolve_device, synchronize


@dataclass(frozen=True)
class GateParams:
    alpha: float = 1.0
    beta: float = 1.0
    gamma: float = 1.0
    rule: str = "le"


def gate_objective(L_norm, e_norm, c_norm, gate: GateParams = GateParams(),
                   *, d_norm=1.0, delta: float = 0.0):
    """The gate's cost ``J(x) = (αL + βE + γC + δ(1−D)) / (α+β+γ+δ)``.

    Array-agnostic on purpose (tensors, numpy arrays or floats), as in
    the reference.  ``delta=0`` (default) is the classic three-term
    objective exactly."""
    den = gate.alpha + gate.beta + gate.gamma + delta
    return (gate.alpha * L_norm + gate.beta * e_norm
            + gate.gamma * c_norm + delta * (1.0 - d_norm)) / den


def gate_admit(J, tau, rule: str = "le"):
    """Admission direction: ``rule='le'`` admits low-cost requests
    (the repo default); ``'ge'`` is the paper's literal Eq. 2 reading."""
    return (J <= tau) if rule == "le" else (J >= tau)


def make_gated_classify_step(cfg: dict, *, exit_layer: int = 2,
                             capacity: int | None = None,
                             gate: GateParams = GateParams(),
                             device="cuda") -> Callable:
    """Returns step(model, tokens, tau, e_norm, c_norm, n_valid=None)
    -> (pred [B], admitted [B] bool, entropy [B]), tensors on ``device``
    (the card by default).  ``n_valid`` marks how many leading rows are
    real requests; pad rows beyond it can never be admitted.

    ``e_norm``/``c_norm`` are the normalised meter/congestion scalars
    snapshotted on the host (the slow loop); ``tau`` the current
    threshold.  All three enter as f32 scalars on the device, so J is
    computed in f32 as the reference's jit computes it.  ``capacity``
    bounds how many requests may take the full model per step
    (default B//2)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(model, tokens, tau, e_norm, c_norm, n_valid=None):
        tokens = torch.as_tensor(tokens).to(dev, torch.long)
        B = tokens.shape[0]
        cap = capacity or max(B // 2, 1)
        f32 = dict(dtype=torch.float32, device=dev)

        # 1-2: proxy + the entropy kernel (the L(x) hot spot)
        proxy_lg = model.early_exit_logits(tokens, exit_layer=exit_layer)
        ent, maxp, proxy_pred = kops.entropy_stats(proxy_lg, impl="auto")
        n_classes = proxy_lg.shape[-1]
        L = ent / torch.tensor(math.log(n_classes), **f32)

        # 3: vectorised J(x) vs tau (the shared gate core)
        J = gate_objective(L, torch.tensor(e_norm, **f32),
                           torch.tensor(c_norm, **f32), gate)
        admit = gate_admit(J, torch.tensor(tau, **f32), gate.rule)
        if n_valid is not None:
            # partial batch: zero-pad rows look confident (low J) and
            # would steal capacity from real requests — mask them out
            admit = admit & (torch.arange(B, device=dev) < n_valid)

        # 4: bucket the `cap` best (lowest-J) admitted requests; the
        # stable sort keeps the lower index on a tie, as lax.top_k does
        score = torch.where(admit, -J, torch.tensor(-math.inf, **f32))
        idx = torch.sort(score, descending=True, stable=True).indices[:cap]
        in_bucket = torch.zeros(B, dtype=torch.bool, device=dev)
        in_bucket[idx] = True
        in_bucket &= admit
        full_pred = model.logits(tokens[idx]).argmax(-1).to(torch.int32)

        # 5: scatter back; everyone else gets the proxy answer
        pred = proxy_pred.clone()
        pred[idx] = torch.where(in_bucket[idx], full_pred, proxy_pred[idx])
        return pred, in_bucket, ent

    return step


def serve_gated(cfg: dict, model, tokens, *, tau_schedule,
                exit_layer: int = 2, batch: int = 64,
                gate: GateParams = GateParams(), meter=None,
                device="cuda"):
    """Batched offline serving through the gated step.  Returns
    (preds [N], admitted [N], entropies [N]); tau_schedule(t) is
    evaluated once per batch (the slow closed loop).

    The energy leg of the loop is LIVE: each batch's measured walltime
    becomes modelled joules in an :class:`EnergyMeter` EWMA over the
    ADMITTED requests, and the next batch's ``e_norm`` is that
    joules/request EWMA squashed against twice the first admitting
    batch's level (the reference's rule)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    step = make_gated_classify_step({**cfg}, exit_layer=exit_layer,
                                    gate=gate, device=dev)
    meter = meter if meter is not None else EnergyMeter()
    tokens = np.asarray(tokens)
    N = len(tokens)
    preds = np.zeros(N, np.int32)
    admits = np.zeros(N, bool)
    ents = np.zeros(N, np.float32)
    # warm outside the timed loop: the first call builds the CUDA kernel
    # and creates the context; timed, it would inflate e_ref ~1000x
    warm = np.zeros((batch,) + tokens.shape[1:], tokens.dtype)
    step(model, warm, 1.0, 0.5, 0.0, batch)
    synchronize(dev)
    e_norm = 0.5                          # seed until the meter has data
    e_ref = None                          # first measured joules/request
    for start in range(0, N, batch):
        chunk = tokens[start:start + batch]
        n = len(chunk)
        if n < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - n,) + chunk.shape[1:],
                                 chunk.dtype)])
        tau = float(tau_schedule(start))
        c_norm = 0.0                      # offline: no queue pressure
        t0 = time.perf_counter()
        p, a, e = step(model, chunk, tau, e_norm, c_norm, n)
        synchronize(dev)
        dt = time.perf_counter() - t0
        preds[start:start + n] = p[:n].cpu().numpy()
        admits[start:start + n] = a[:n].cpu().numpy()
        ents[start:start + n] = e[:n].cpu().numpy()
        # close the loop: walltime joules over the admitted share ->
        # EWMA -> next batch's e_norm
        n_adm = int(admits[start:start + n].sum())
        meter.record(meter.model.p_active * dt, n_requests=n_adm)
        if e_ref is None and meter.joules_per_request > 0:
            e_ref = meter.joules_per_request
        if e_ref is not None:
            e_norm = float(np.clip(
                meter.joules_per_request / (2.0 * e_ref), 0.0, 1.0))
    return preds, admits, ents
