"""Mixture-of-Experts FFN, ported from ``repro.models.moe``.

The reference's function, exactly, including what it drops: tokens in
groups of g = min(1024, N) (the last zero-padded), an f32 router,
softmax, top-k (ties to the lower expert index, as ``jax.lax.top_k``),
the top-k weights renormalised by ``sum + 1e-9``, a per-group capacity
C = min(g, max(k, int(cf * g * k / E))) per expert, and GShard's
position priority per k-slot: slot j of a token keeps its place when
the tokens before it in the group that chose the same expert at slot
j, plus every token kept there at slots 0..j-1, number fewer than C.
The combine weights are cast to the activation dtype (bf16 in a bf16
model) and summed in f32; the Switch load-balance loss reads each
token's first choice, padding included.

Where the reference builds [G, g, E, C] one-hot dispatch and combine
tensors for the TPU's dense einsums, the port computes each kept
(token, k-slot)'s expert row once: the counts before slot j are
``min(sum of earlier slots' choices, C)`` (a slot keeps ``min(n, C -
kept so far)`` tokens), so every slot's positions come from one
one-hot [G, g, k, E] and two cumulative sums, with no loop over k.
Tokens are gathered into a static [E, G*C, D] buffer (an empty row
reads a zero row), the experts run as three batched products, and each
token's kept rows are gathered back and combined.  Every shape is
static and nothing syncs with the host, so the decode window that runs
it is captured as a CUDA graph.  The reference computes MoE outside any
Pallas kernel; the products here are plain ``torch.bmm``.

Under a mesh (``launch.sharding.sharded``), ``ACTIVATION_SHARDING``
holds the mesh's ``MoESharding``, the counterpart of the reference's
``ACTIVATION_SHARDING`` hook: the tokens and the router are gathered,
and the routing and the dispatch by index run as plain tensors on every
rank, so the same tokens drop as in an unsharded step; the expert
products run as DTensor ops on the rows it places, and the output goes
back to the input's placements.  The context sets and resets it;
outside one it is None.

A sigmoid router (``score="sigmoid"``, DeepSeek-V3's ``noaux_tc`` with
one group) scores each expert ``s = sigmoid(x R)`` in f32, chooses the
top k on ``s + bias`` (the float32 correction bias enters the choice
only; ties to the lower index), and weighs the chosen experts by their
uncorrected ``s`` over their sum (+1e-20), times ``scale``.  A layer
with shared experts (``MoEParams(..., d_ff_shared=...)``) adds one
SwiGLU of that width, taken by every token, to the routed sum.  The
softmax router is untouched by either.
"""
from __future__ import annotations

import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import nn as nn_
from repro_torch.models.nn import param

GROUP_SIZE = 1024

ACTIVATION_SHARDING: contextvars.ContextVar = contextvars.ContextVar(
    "moe_activation_sharding", default=None)


class MoEParams(nn.Module):
    """The reference's ``moe_params`` leaves: ``router`` [D, E] f32
    whatever the model's dtype, ``w_gate`` / ``w_up`` [E, D, F] and
    ``w_down`` [E, F, D]; with ``router_bias``, ``router_bias`` [E] f32;
    with ``d_ff_shared`` > 0, the shared SwiGLU ``shared_gate`` /
    ``shared_up`` [D, Fs] and ``shared_down`` [Fs, D]."""

    def __init__(self, d_model: int, n_experts: int, d_ff_e: int, *,
                 d_ff_shared: int = 0, router_bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.router = param(d_model, n_experts, device=device)
        self.router_bias = (param(n_experts, device=device) if router_bias
                            else None)
        self.w_gate = param(n_experts, d_model, d_ff_e, **kw)
        self.w_up = param(n_experts, d_model, d_ff_e, **kw)
        self.w_down = param(n_experts, d_ff_e, d_model, **kw)
        if d_ff_shared:
            self.shared_gate = param(d_model, d_ff_shared, **kw)
            self.shared_up = param(d_model, d_ff_shared, **kw)
            self.shared_down = param(d_ff_shared, d_model, **kw)
        self.shared = bool(d_ff_shared)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Fan-in init of the router and of every expert's matrices; the
        correction bias at zero."""
        nn_.dense_init_(self.router, gen)
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                nn_.dense_init_(w[e], gen)
        if self.router_bias is not None:
            with torch.no_grad():
                self.router_bias.zero_()
        if self.shared:
            for w in (self.shared_gate, self.shared_up, self.shared_down):
                nn_.dense_init_(w, gen)


def capacity(g: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Rows per expert and group, the reference's rule."""
    return min(g, max(top_k, int(capacity_factor * g * top_k / n_experts)))


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int,
          capacity_factor: float, *, score: str = "softmax",
          bias: torch.Tensor | None = None, scale: float = 1.0):
    """The routing of groups xg [G, g, D]: -> (gates [G, g, E] f32, top-k
    weights [G, g, k] f32 and experts [G, g, k] (ties to the lower
    index), each (token, k-slot)'s row in its expert [G, g, k], whether it
    was kept [G, g, k], and the capacity C).  ``score="sigmoid"`` routes
    as the module docstring says; its ``gates`` are the scores over
    their sum, what the load-balance loss reads."""
    G, g, _ = xg.shape
    E = router.shape[1]
    logits = xg.float() @ router
    if score == "softmax":
        gates = torch.softmax(logits, dim=-1)
        # a stable descending sort keeps equal gates in index order
        w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
        w, idx = w[..., :top_k], idx[..., :top_k]
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
    else:
        s = torch.sigmoid(logits)
        _, idx = torch.sort(s if bias is None else s + bias, dim=-1,
                            descending=True, stable=True)
        idx = idx[..., :top_k]
        w = s.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
        gates = s / s.sum(-1, keepdim=True)
    C = capacity(g, top_k, E, capacity_factor)
    onehot = (idx[..., None] == torch.arange(E, device=xg.device)).long()
    # kept before slot j: min(choices at slots < j, C), per expert
    n = onehot.sum(1)                                          # [G, k, E]
    before = (n.cumsum(1) - n).clamp(max=C)
    rank = onehot.cumsum(1) - 1                                # [G, g, k, E]
    pos = (rank + before[:, None]).gather(-1, idx[..., None])[..., 0]
    return gates, w, idx, pos, pos < C, C


def routed_work(n_tokens: int, top_k: int, n_experts: int,
                capacity_factor: float,
                group_size: int = GROUP_SIZE) -> tuple[int, int]:
    """What ``moe_forward`` does over ``n_tokens`` tokens, from the shapes
    alone: (the (token, expert) pairs it routes, padding rows included,
    and the expert rows its products multiply, E x G x C)."""
    if n_tokens <= 0:
        return 0, 0
    g = min(group_size, n_tokens)
    G = -(-n_tokens // g)
    return (G * g * top_k,
            n_experts * G * capacity(g, top_k, n_experts, capacity_factor))


def moe_forward(p: MoEParams, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25,
                group_size: int = GROUP_SIZE, need_aux: bool = True,
                score: str = "softmax", scale: float = 1.0):
    """x [B, S, D] -> (y [B, S, D], the aux loss, an f32 scalar; None
    when ``need_aux`` is False, as on a decode step, whose aux the
    reference discards).  ``score`` and ``scale`` pick the router
    (``route``); the shared SwiGLU, when ``p`` has one, is added to every
    token's routed sum."""
    shard = ACTIVATION_SHARDING.get()
    x_in, x = x, x if shard is None else shard.gather(x)
    B, S, D = x.shape
    E = p.router.shape[1]
    N = B * S
    g = min(group_size, N)
    G = -(-N // g)
    xt = F.pad(x.reshape(N, D), (0, 0, 0, G * g - N))          # [G*g, D]
    router = p.router if shard is None else shard.gather(p.router)
    bias = p.router_bias
    if shard is not None and bias is not None:
        bias = shard.gather(bias)
    gates, w, idx, pos, keep, C = route(router, xt.reshape(G, g, D),
                                        top_k, capacity_factor, score=score,
                                        bias=bias, scale=scale)
    # row of each kept (token, k-slot) in the [E, G, C] expert buffer;
    # a dropped one points past it
    grp = torch.arange(G, device=x.device)[:, None, None]
    row = torch.where(keep, (idx * G + grp) * C + pos, E * G * C)
    tok = torch.arange(G * g, device=x.device).reshape(G, g, 1)
    # which token fills each row; an empty row reads the zero row G*g
    src = torch.full((E * G * C + 1,), G * g, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, row.reshape(-1), tok.expand(G, g, top_k).reshape(-1))
    xz = torch.cat([xt, xt.new_zeros(1, D)])
    xe = xz[src[:-1]].reshape(E, G * C, D)
    if shard is not None:
        xe = shard.constrain(xe, ("experts", "tokens", None))
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    ye = torch.bmm(h, p.w_down).reshape(E * G * C, D)
    if shard is not None:
        ye = shard.gather(ye)
    # combine: weights in the activation dtype, summed in f32
    cw = torch.where(keep, w, 0.0).to(x.dtype).float().reshape(G * g, top_k)
    yk = ye[torch.where(keep, row, 0).reshape(G * g, top_k)].float()
    y = (cw[..., None] * yk).sum(1).to(x.dtype)[:N].reshape(B, S, D)
    if shard is not None:
        y = shard.like(y, x_in)
    if p.shared:
        y = y + (F.silu(x_in @ p.shared_gate) * (x_in @ p.shared_up)) \
            @ p.shared_down
    if not need_aux:
        return y, None
    # load balance (Switch eq. 4): E * <f_e * P_e> over every group row
    first = (idx[..., 0, None] == torch.arange(E, device=x.device)).float()
    aux = E * (first.mean((0, 1)) * gates.mean((0, 1))).sum()
    return y, aux if shard is None else shard.like(aux)
