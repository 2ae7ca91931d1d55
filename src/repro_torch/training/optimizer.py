"""AdamW + global-norm clipping + schedules, ported from
``repro.training.optimizer`` (plain functions on tensors, no
``torch.optim``).

Params, grads and the moments are flat ``{name: tensor}`` dicts (a
module's ``named_parameters()``).  ``update_`` updates them in place,
leaf by leaf, which the train steps use: a functional update of
stablelm-3b would hold bf16 params and grads, f32 scaled grads, the old
and the new moments and the new params at once, about 73 GB, against
34 GB in place.  ``update`` returns new tensors, as the reference
returns a new pytree (``update_`` on copies).  The arithmetic is the reference's, not
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

    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor], *,
               lr_scale: torch.Tensor | float = 1.0):
        """-> (new params, new state, the global norm before clipping);
        ``update_`` on copies, so nothing given is changed."""
        new_p = {k: p.detach().clone() for k, p in params.items()}
        new_s = AdamWState(m={k: t.clone() for k, t in state.m.items()},
                           v={k: t.clone() for k, t in state.v.items()},
                           count=state.count)
        new_s, gnorm = self.update_(grads, new_s, new_p, lr_scale=lr_scale)
        return new_p, new_s, gnorm

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
                params: Mapping[str, torch.Tensor], *,
                lr_scale: torch.Tensor | float = 1.0):
        """The update in place: the clip scale from the global norm of
        every gradient first, then per leaf the moments (``state.m``,
        ``state.v`` overwritten), the bias-corrected step and the weight
        decay on the f32 param, written back into ``params``; no more
        than one leaf's f32 temporaries live at once.  -> (the state with
        the incremented count, the global norm before clipping)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        # the reference's f32 powers of the traced count
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = self.lr * lr_scale
        for k, p in params.items():
            g = grads[k].float() * scale
            m = state.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            v = state.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            del g
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            upd = upd + self.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
        return state._replace(count=count), gnorm


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
