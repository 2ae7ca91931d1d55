"""Mamba-2 SSD block, ported from ``repro.models.ssd`` (state-space
duality, arXiv:2405.21060).

The block projects x to (z, xBC, dt), runs a causal depthwise conv over
xBC, scans the sequence with a per-head scalar decay
a_t = exp(-exp(A_log) dt_t), adds the skip ``D x``, gates with
``silu(z)``, normalises and projects out.  Decode carries an O(1)
state: the conv tail [B, W-1, ch] and the SSD state [B, H, hd, N],
both f32.

The scan of a chunked call (prefill, full sequence) goes through the
port's kernel dispatch when ``impl`` is given (``kernels.ops``: the
hand-written CUDA kernel on the card, the plain versions on the CPU),
and through the model's own chunked algorithm (``ssd_chunked_plain``,
the reference's ``ssd_chunked``) when it is None.  The single-step
branch of a decode step stays plain PyTorch, as it stays jnp in the
reference: it is no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.kernels.ssd_scan import ssd_chunked_plain
from repro_torch.models import nn as nn_
from repro_torch.models.nn import param


class SSDParams(nn.Module):
    """The reference's ``ssd_params`` leaves, names and shapes:
    ``in_proj`` [d, 2 d_inner + 2 N + H], ``conv_w`` [W, ch], ``conv_b``
    [ch], ``A_log`` / ``D`` / ``dt_bias`` [H] f32, ``norm.scale``
    [d_inner] f32 and ``out_proj`` [d_inner, d]; ch = d_inner + 2 N."""

    def __init__(self, d_model: int, *, expand: int, headdim: int,
                 d_state: int, conv_width: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.d_inner = expand * d_model
        self.n_heads = self.d_inner // headdim
        self.headdim, self.d_state = headdim, d_state
        conv_ch = self.d_inner + 2 * d_state
        self.in_proj = param(d_model, 2 * self.d_inner + 2 * d_state
                             + self.n_heads, device=device, dtype=dtype)
        self.conv_w = param(conv_width, conv_ch, device=device, dtype=dtype)
        self.conv_b = param(conv_ch, device=device, dtype=dtype)
        self.A_log = param(self.n_heads, device=device)
        self.D = param(self.n_heads, device=device)
        self.dt_bias = param(self.n_heads, device=device)
        self.norm = nn_.RMSNorm(self.d_inner, device=device)
        self.out_proj = param(self.d_inner, d_model, device=device,
                              dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's initialisers: fan-in dense projections, a
        0.1-scaled normal conv drawn in f32, zero conv bias, A_log the
        log of 1..16 spread over the heads, D ones, dt_bias zeros."""
        nn_.dense_init_(self.in_proj, gen)
        with torch.no_grad():
            w = torch.empty_like(self.conv_w, dtype=torch.float32)
            self.conv_w.copy_(w.normal_(generator=gen).mul_(0.1))
            self.conv_b.zero_()
            self.A_log.copy_(torch.linspace(1.0, 16.0, self.n_heads).log())
            self.D.fill_(1.0)
            self.dt_bias.zero_()
        self.norm.reset_parameters()
        nn_.dense_init_(self.out_proj, gen)


class SSDState(NamedTuple):
    conv: torch.Tensor     # [B, W-1, conv_ch] float32
    h: torch.Tensor        # [B, H, hd, N] float32


def init_ssd_state(batch: int, d_model: int, *, expand: int, headdim: int,
                   d_state: int, conv_width: int,
                   device="cuda") -> SSDState:
    """A zero state for ``batch`` rows, on the card by default."""
    return ssd_state_zeros(batch, d_model, expand=expand, headdim=headdim,
                           d_state=d_state, conv_width=conv_width,
                           dev=resolve_device(device))


def ssd_state_zeros(batch: int, d_model: int, *, expand: int, headdim: int,
                    d_state: int, conv_width: int,
                    dev: torch.device) -> SSDState:
    """``init_ssd_state``'s zeros on a device already chosen (the cache
    builder's, the meta device among them)."""
    d_inner = expand * d_model
    return SSDState(
        conv=torch.zeros(batch, conv_width - 1, d_inner + 2 * d_state,
                         device=dev),
        h=torch.zeros(batch, d_inner // headdim, headdim, d_state,
                      device=dev))


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int,
                n_heads: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, xBC, dt


def _conv1d(p: SSDParams, x: torch.Tensor, tail: torch.Tensor):
    """Causal depthwise conv of x [B, S, ch] after the tail [B, W-1, ch]
    in x's dtype, then SiLU; -> (y, the new tail in f32)."""
    W = p.conv_w.shape[0]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xt[:, i:i + x.shape[1]] * p.conv_w[i] for i in range(W))
    y = F.silu(y + p.conv_b)
    return y, xt[:, xt.shape[1] - (W - 1):].float()


def ssd_block(p: SSDParams, x: torch.Tensor, state: SSDState | None, *,
              chunk: int, single_step: bool = False,
              impl: str | None = None) -> torch.Tensor:
    """The Mamba-2 block: x [B, S, D] -> y [B, S, D].

    ``state`` is updated IN PLACE (conv tail and SSD state), where the
    reference returns a new one; ``None`` runs from a zero state and
    keeps nothing (the full-sequence mode).  ``single_step`` (S = 1,
    a decode step) needs a state.  ``impl`` routes the chunked scan
    through ``kernels.ops`` ("auto", "ref", "cuda"); None takes the
    model's own chunked algorithm at ``chunk``."""
    B_, S, _ = x.shape
    d_inner, H, hd, N = p.d_inner, p.n_heads, p.headdim, p.d_state
    z, xBC, dt = _split_proj(x @ p.in_proj, d_inner, N, H)
    tail = (state.conv if state is not None else
            torch.zeros(B_, p.conv_w.shape[0] - 1, xBC.shape[-1],
                        device=x.device))
    xBC, new_tail = _conv1d(p, xBC, tail)
    xf = xBC[..., :d_inner].reshape(B_, S, H, hd).float()
    Bf = xBC[..., d_inner:d_inner + N].float()
    Cf = xBC[..., d_inner + N:].float()
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    if single_step:
        a = torch.exp(A[None, :] * dt[:, 0])                  # [B,H]
        dx = dt[:, 0, :, None] * xf[:, 0]                     # [B,H,hd]
        h = state.h.mul_(a[:, :, None, None]).add_(
            dx[..., None] * Bf[:, 0, None, None, :])
        y = torch.einsum("bn,bhdn->bhd", Cf[:, 0], h)[:, None]
    elif state is None:
        if impl is None:
            h0 = torch.zeros(B_, H, hd, N, device=x.device)
            y, _ = ssd_chunked_plain(xf, dt, A, Bf, Cf, h0, chunk)
        else:
            y = ops.ssd_scan(xf, dt, A, Bf, Cf, chunk=chunk, impl=impl)
    else:
        if impl is None:
            y, h = ssd_chunked_plain(xf, dt, A, Bf, Cf, state.h, chunk)
        else:
            y, h = ops.ssd_chunked(xf, dt, A, Bf, Cf, state.h, chunk=chunk,
                                   impl=impl)
        state.h.copy_(h)
    if state is not None:
        state.conv.copy_(new_tail)
    y = y + p.D[None, None, :, None] * xf
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = nn_.rmsnorm(p.norm.scale, y * F.silu(z))
    return y @ p.out_proj

