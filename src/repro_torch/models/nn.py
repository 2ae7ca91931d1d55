"""Low-level building blocks, ported from ``repro.models.nn``.

Parameters keep the reference's layout and names — dense weights are
``[d_in, d_out]`` applied as ``x @ W`` — so a reference checkpoint maps
onto a module's ``state_dict`` key for key (``/`` becomes ``.``) with no
transposes.  Initialisers draw from an explicit ``torch.Generator``;
they give other numbers than ``jax.random`` for the same seed, so
parity tests carry the reference's weights across instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# initialisers (in place, on the parameter's own device)
# ---------------------------------------------------------------------------

def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init of a ``[d_in, d_out]`` matrix,
    drawn in f32 and then cast to ``w``'s dtype, as the reference."""
    with torch.no_grad():
        if w.dtype != torch.float32:
            return w.copy_(dense_init_(torch.empty_like(w, dtype=torch.float32),
                                       gen))
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(1.0 / math.sqrt(w.shape[0]))


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        if w.dtype != torch.float32:
            return w.copy_(embed_init_(torch.empty_like(w, dtype=torch.float32),
                                       gen))
        return w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=gen)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def param(*shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised, frozen parameter.  Weights take the model's
    dtype (``cfg.dtype``); norms stay f32, as in the reference."""
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


class LayerNorm(nn.Module):
    """``scale``/``bias`` LayerNorm (ones/zeros at init)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = param(d, device=device)
        self.bias = param(d, device=device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x)


class RMSNorm(nn.Module):
    """Gemma-style RMSNorm, ``x * (1 + scale)`` (zeros at init)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = param(d, device=device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


def norm(kind: str, d: int, *, device=None) -> nn.Module:
    """``cfg.norm``'s module: RMSNorm or LayerNorm."""
    return RMSNorm(d, device=device) if kind == "rmsnorm" else LayerNorm(
        d, device=device)


class MLP(nn.Module):
    """``gelu(x @ w_up + b_up) @ w_down + b_down``."""

    def __init__(self, d: int, f: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w_up = param(d, f, device=device, dtype=dtype)
        self.b_up = param(f, device=device, dtype=dtype)
        self.w_down = param(f, d, device=device, dtype=dtype)
        self.b_down = param(d, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dense_init_(self.w_up, gen)
        dense_init_(self.w_down, gen)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_down.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


class SwiGLU(nn.Module):
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down``; ``act`` is SiLU,
    or tanh-GELU for ``cfg.act == "gelu"``."""

    def __init__(self, d: int, f: int, *, act: str = "silu", device=None,
                 dtype=torch.float32):
        super().__init__()
        self.act = gelu if act == "gelu" else F.silu
        self.w_gate = param(d, f, device=device, dtype=dtype)
        self.w_up = param(d, f, device=device, dtype=dtype)
        self.w_down = param(f, d, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.act(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, as the reference."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, gemma-style ``(1 + scale)``, as the reference."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale)).to(dt)


def rope_angles(positions: torch.Tensor, rotary_dim: int,
                theta: float = 10000.0, *, heads: bool = True):
    """(cos, sin) in f32 for ``positions`` [S] or [B, S], shaped to
    broadcast against the rotated part of [B, S, H, rd] (``heads``) or
    [B, S, rd]: the reference's ``rope_frequencies`` and angles, which a
    decode step computes once for all of its layers."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=positions.device)
                           / rotary_dim))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv
    if heads:
        ang = ang[:, :, None, :]
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``rd = 2 * cos.shape[-1]`` features of ``x`` by
    INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` of that part, as
    the reference's ``apply_rope`` does (not HF's ``rotate_half``); the
    rest passes through."""
    rd = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


def apply_rope(x: torch.Tensor, positions, theta: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """Rotate ``x`` ([B, S, H, D] or [B, S, D]) by position; positions
    [S] or [B, S]; ``rotary_dim`` < D is partial rotary (stablelm's
    25 %)."""
    positions = torch.as_tensor(positions, device=x.device)
    cos, sin = rope_angles(positions, rotary_dim or x.shape[-1], theta,
                           heads=x.dim() == 4)
    return rotate(x, cos, sin)


def sinusoidal_positions(seq: int, d: int, *, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position table [seq, d] in f32:
    sines over the first half of the features, cosines over the
    second."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / 10000.0 ** (2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ p.w_up + p.b_up) @ p.w_down + p.b_down
