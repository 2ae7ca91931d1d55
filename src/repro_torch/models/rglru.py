"""RG-LRU recurrent block, ported from ``repro.models.rglru``
(RecurrentGemma / Griffin, arXiv:2402.19427).

The block splits x into a linear branch and a gate branch; the linear
branch runs a causal depthwise conv1d, then the RG-LRU, is gated by
``gelu(gate)`` and projected out.  The recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                  (input gate)
    a_t = exp(c * r_t * log(sigmoid(Lambda)))     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is diagonal and linear in h, so a prompt runs it as a log-depth scan of
``(a, b) . (a', b') = (a a', a' b + b')`` over the sequence (the
reference's ``jax.lax.associative_scan``; the reference runs no Pallas
kernel here, so the port's scan is plain PyTorch): ceil(log2 S) passes
over [B, S, R] in f32, a few kernels each, where a loop over the tokens
would issue some 26 small kernels per token.  A decode step is one
fused update of h.  The gates and the state are f32 whatever the
weights' type, as the reference's.

The state (h [B, R] and the conv tail [B, W-1, R], both f32) is updated
IN PLACE by ``rglru_block``, where the reference returns a new one;
``None`` runs from a zero state and keeps nothing (the full-sequence
mode).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import nn as nn_
from repro_torch.models.nn import param

_C = 8.0


class RGLRUParams(nn.Module):
    """The reference's ``rglru_params`` leaves, names and shapes:
    ``w_in`` / ``w_gate`` [d, R], ``conv_w`` [W, R], ``conv_b`` [R],
    ``w_a`` / ``w_x`` [R, R], ``b_a`` / ``b_x`` / ``lam`` [R] f32 and
    ``w_out`` [R, d]."""

    def __init__(self, d_model: int, width: int, conv_width: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_in = param(d_model, width, **kw)
        self.w_gate = param(d_model, width, **kw)
        self.conv_w = param(conv_width, width, **kw)
        self.conv_b = param(width, **kw)
        self.w_a = param(width, width, **kw)
        self.b_a = param(width, device=device)
        self.w_x = param(width, width, **kw)
        self.b_x = param(width, device=device)
        self.lam = param(width, device=device)
        self.w_out = param(width, d_model, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's initialisers: fan-in projections, the gates'
        at scale 0.01, a 0.01-scaled normal conv drawn in f32, zero
        biases, and Lambda spread over [3, 7] (sigmoid(Lambda) in
        [0.95, 0.999])."""
        nn_.dense_init_(self.w_in, gen)
        nn_.dense_init_(self.w_gate, gen)
        with torch.no_grad():
            w = torch.empty_like(self.conv_w, dtype=torch.float32)
            self.conv_w.copy_(w.normal_(generator=gen).mul_(0.01))
            self.conv_b.zero_()
            for g in (self.w_a, self.w_x):
                w = torch.empty_like(g, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                g.copy_(w.mul_(0.01))
            self.b_a.zero_()
            self.b_x.zero_()
            self.lam.copy_(torch.linspace(3.0, 7.0, self.lam.shape[0]))
        nn_.dense_init_(self.w_out, gen)


class RGLRUState(NamedTuple):
    h: torch.Tensor        # [B, R] float32 recurrent state
    conv: torch.Tensor     # [B, W-1, R] float32 conv tail


def init_rglru_state(batch: int, width: int, conv_width: int, *,
                     device="cuda") -> RGLRUState:
    """A zero state for ``batch`` rows, on the card by default."""
    dev = resolve_device(device)
    return RGLRUState(h=torch.zeros(batch, width, device=dev),
                      conv=torch.zeros(batch, conv_width - 1, width,
                                       device=dev))


def _conv1d(p: RGLRUParams, x: torch.Tensor, tail: torch.Tensor):
    """Causal depthwise conv of x [B, S, R] after the tail [B, W-1, R],
    in x's dtype; -> (y, the new tail in f32)."""
    W = p.conv_w.shape[0]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xt[:, i:i + x.shape[1]] * p.conv_w[i] for i in range(W))
    return y + p.conv_b, xt[:, xt.shape[1] - (W - 1):].float()


def _gates(p: RGLRUParams, x: torch.Tensor):
    """x [..., R] -> (a_t, the gated input b_t), both f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(xf @ p.w_x.float() + p.b_x)
    log_a = _C * r * F.logsigmoid(p.lam)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along dim 1, as a log-depth
    (Hillis-Steele) scan: pass k combines each element with the one
    2^k before it, ``(A, B)[t] <- (A[t-d] A[t], A[t] B[t-d] + B[t])``,
    ceil(log2 S) passes.  Every product is of factors in (0, 1], so
    nothing overflows however long the sequence."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p: RGLRUParams, x: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU: x [B, S, R], h0 [B, R] -> (y [B, S, R] in
    x's dtype, h_last [B, R] f32).  h0 is folded into the first step,
    ``b_1 += a_1 h0``, as the reference does."""
    a, b = _gates(p, x)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: RGLRUParams, x: torch.Tensor,
               h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: x [B, 1, R], h [B, R] -> (y [B, 1, R], h_new)."""
    a, b = _gates(p, x[:, 0])
    h_new = a * h + b
    return h_new[:, None].to(x.dtype), h_new


def rglru_block(p: RGLRUParams, x: torch.Tensor, state: RGLRUState | None,
                *, single_step: bool = False) -> torch.Tensor:
    """The temporal-mixing block: x [B, S, D] -> y [B, S, D].  ``state``
    is updated in place; ``None`` starts from a zero state and keeps
    nothing.  ``single_step`` (S = 1, a decode step) needs a state."""
    gate = nn_.gelu(x @ p.w_gate)
    u = x @ p.w_in
    B, R = x.shape[0], u.shape[-1]
    if state is None:
        tail = torch.zeros(B, p.conv_w.shape[0] - 1, R, device=x.device)
        h0 = torch.zeros(B, R, device=x.device)
    else:
        tail, h0 = state.conv, state.h
    u, new_tail = _conv1d(p, u, tail)
    if single_step:
        y, h = rglru_step(p, u, h0)
    else:
        y, h = rglru_scan(p, u, h0)
    if state is not None:
        state.h.copy_(h)
        state.conv.copy_(new_tail)
    return (y * gate) @ p.w_out
