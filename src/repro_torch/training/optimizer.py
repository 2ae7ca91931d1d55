"""AdamW + global-norm clipping + schedules, ported from
``repro.training.optimizer`` (plain functions on tensors, no
``torch.optim``).

Params, grads and the moments are flat ``{name: tensor}`` dicts (a
module's ``named_parameters()``); ``update`` returns new tensors, as the
reference returns a new pytree.  The arithmetic is the reference's, not
``torch.optim.AdamW``'s: ``b2 = 0.95``; the global-norm clip inside the
update, scaling by ``min(1, clip / (gnorm + 1e-9))``; weight decay added
to the update before the learning rate, on every leaf; bias corrections
from the incremented count; and the norm BEFORE clipping returned.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: int


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(m={k: zeros(p) for k, p in params.items()},
                          v={k: zeros(p) for k, p in params.items()},
                          count=0)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor], *,
               lr_scale: torch.Tensor | float = 1.0):
        """-> (new params, new state, the global norm before clipping)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = {k: g.float() * scale for k, g in grads.items()}
        count = state.count + 1
        # the reference's f32 powers of the traced count
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        new_m = {k: self.b1 * state.m[k] + (1 - self.b1) * g
                 for k, g in grads.items()}
        new_v = {k: self.b2 * state.v[k] + (1 - self.b2) * g * g
                 for k, g in grads.items()}
        lr = self.lr * lr_scale

        def step(p, m, v):
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            upd = upd + self.weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new_p = {k: step(p, new_m[k], new_v[k]) for k, p in params.items()}
        return new_p, AdamWState(m=new_m, v=new_v, count=count), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over a dict's (or a sequence's)
    tensors, in f32."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1) -> torch.Tensor:
    """lr multiplier: linear warmup then cosine decay to ``floor``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
