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
    """Truncated-normal (±2σ) fan-in init of a ``[d_in, d_out]`` matrix."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(1.0 / math.sqrt(w.shape[0]))


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=gen)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


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


class MLP(nn.Module):
    """``gelu(x @ w_up + b_up) @ w_down + b_down``."""

    def __init__(self, d: int, f: int, *, device=None):
        super().__init__()
        self.w_up = param(d, f, device=device)
        self.b_up = param(f, device=device)
        self.w_down = param(f, d, device=device)
        self.b_down = param(d, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dense_init_(self.w_up, gen)
        dense_init_(self.w_down, gen)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_down.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ p.w_up + p.b_up) @ p.w_down + p.b_down
