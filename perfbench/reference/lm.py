"""The plain decoder LM of the benchmark's configurations, in float32 with
TF32 off: one causal pass over a whole sequence, no cache, no kernels,
no batching, one layer's weights widened to float32 at a time.

Semantics, from the published architectures in the port's parameter
layout (``perfbench/lib/weights.py``): pre-norm residual blocks;
LayerNorm (population variance, eps 1e-5) or RMSNorm ``x * (1 +
scale)`` (eps 1e-6); GQA attention with rotary position on the first
``rope_pct`` of each head's features, rotated by interleaved pairs
``(x[2i], x[2i+1])`` with frequencies ``theta ** (-2i / rotary_dim)``,
softmax of ``q k / sqrt(hd)`` under a causal mask; a SwiGLU MLP
``(silu(x Wg) * (x Wu)) Wd``, or a mixture of experts: ``softmax(x R)``
over the experts, the top ``k`` renormalised by their sum (+1e-9), each
token's chosen experts' SwiGLU outputs summed with those weights, no
token dropped; a final norm and an untied or tied unembedding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _norm(z, w, prefix, x):
    if z["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * w(f"{prefix}.scale") \
            + w(f"{prefix}.bias")
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + w(f"{prefix}.scale"))


def _rotary(x, positions, rd, theta):
    """Rotate the first ``rd`` features of x [S, heads, hd] by interleaved
    pairs."""
    if rd == 0:
        return x
    inv = theta ** (-torch.arange(0, rd, 2, device=x.device,
                                  dtype=torch.float64) / rd)
    ang = (positions.double()[:, None] * inv).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0:rd:2], x[..., 1:rd:2]
    rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot.reshape(*x.shape[:-1], rd), x[..., rd:]], -1)


def _attention(z, w, p, x, positions, act):
    S = x.shape[0]
    H, K, hd = z["H"], z["K"], z["hd"]
    xa = act(x)
    q = xa @ w(f"{p}.mix.wq")
    k = xa @ w(f"{p}.mix.wk")
    v = xa @ w(f"{p}.mix.wv")
    if z["bias"]:
        q, k, v = q + w(f"{p}.mix.bq"), k + w(f"{p}.mix.bk"), v + w(f"{p}.mix.bv")
    rd = int(hd * z["rope_pct"])
    q = _rotary(q.view(S, H, hd), positions, rd, z["theta"])
    k = _rotary(k.view(S, K, hd), positions, rd, z["theta"])
    v = v.view(S, K, hd)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    y = act(o.reshape(S, H * hd)) @ w(f"{p}.mix.wo")
    return y + w(f"{p}.mix.bo") if z["bias"] else y


def _swiglu(x, wg, wu, wd, act):
    x = act(x)
    return act(F.silu(x @ wg) * (x @ wu)) @ wd


def _moe(z, w, p, x, act):
    gates = torch.softmax(x @ w(f"{p}.moe.router"), -1)
    top, idx = gates.topk(z["k"], dim=-1)
    top = top / (top.sum(-1, keepdim=True) + 1e-9)
    wg, wu, wd = (w(f"{p}.moe.{n}") for n in ("w_gate", "w_up", "w_down"))
    y = torch.zeros_like(x)
    for e in range(z["E"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y.index_add_(0, tok, _swiglu(x[tok], wg[e], wu[e], wd[e], act)
                         * top[tok, slot, None])
    return y


def _same(x):
    return x


@torch.no_grad()
def logits(z: dict, weight, tokens: torch.Tensor, at: torch.Tensor,
           act=_same) -> torch.Tensor:
    """float32 logits [len(at), V] at positions ``at`` of one causal pass
    over ``tokens`` [S].  ``weight(name)`` gives a parameter as float32;
    ``act`` is applied to every input of a product with a weight (the
    control passes lower-precision values, widened to float32, to
    both)."""
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    h = weight("emb")[tokens]
    for i in range(z["L"]):
        p = f"layers.{i}"
        h = h + _attention(z, weight, p, _norm(z, weight, f"{p}.norm1", h),
                           positions, act)
        x = _norm(z, weight, f"{p}.norm2", h)
        if z["E"]:
            h = h + _moe(z, weight, p, x, act)
        else:
            h = h + _swiglu(x, weight(f"{p}.mlp.w_gate"),
                            weight(f"{p}.mlp.w_up"), weight(f"{p}.mlp.w_down"),
                            act)
    h = act(_norm(z, weight, "final_norm", h[at]))
    return h @ (weight("emb").T if z["tie"] else weight("unemb"))
