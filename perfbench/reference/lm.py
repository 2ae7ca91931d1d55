"""The plain decoder LM of the benchmark's configurations, in float32 with
TF32 off: one causal pass over a whole sequence, no cache, no kernels,
no batching, one layer's weights widened to float32 at a time.

This is the module a configuration names with ``"reference"`` (the
default, ``reference/lm.py``), and so it provides the seven functions
every such module provides (``perfbench/lib/describe.py``): the sizes,
the parameters in drawing order, the logits, the bytes one cached token
takes, and the operation and byte counts of the metric readers.

Semantics, from the published architectures in the port's parameter
layout (``models/nn.py``: dense matrices ``[d_in, d_out]`` applied as
``x @ W``, experts stacked ``[E, d_in, d_out]``, the router ``[d, E]``
in float32, LayerNorm ``scale``/``bias`` and RMSNorm's offset from 1,
both float32): pre-norm residual blocks; LayerNorm (population variance,
eps 1e-5) or RMSNorm ``x * (1 + scale)`` (eps 1e-6); GQA attention with
rotary position on the first ``rope_pct`` of each head's features,
rotated by interleaved pairs ``(x[2i], x[2i+1])`` with frequencies
``theta ** (-2i / rotary_dim)``, softmax of ``q k / sqrt(hd)`` under a
causal mask; a SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wd``, or a mixture of
experts: ``softmax(x R)`` over the experts, the top ``k`` renormalised
by their sum (+1e-9), each token's chosen experts' SwiGLU outputs summed
with those weights, no token dropped; a final norm and an untied or tied
unembedding.

The counts take each input byte read once and each output byte written
once, whatever a kernel reads again.  Attention counts two products of
``2 * hd`` operations per (query, key) pair and head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.lib.weights import DTYPES


def dims(m: dict) -> dict:
    """Sizes of a ``model`` block (the port's ``ModelConfig`` fields)."""
    d, H = m["d_model"], m["n_heads"]
    return dict(d=d, H=H, K=m["n_kv_heads"], hd=m.get("head_dim") or d // H,
                L=m["n_layers"], V=m["vocab"], f=m.get("d_ff", 0),
                E=m.get("n_experts", 0), k=m.get("top_k", 0),
                fe=m.get("d_ff_expert", 0), tie=m.get("tie_embeddings", True),
                norm=m.get("norm", "rmsnorm"), bias=m.get("qkv_bias", False),
                rope_pct=m.get("rope_pct", 1.0),
                theta=m.get("rope_theta", 10000.0),
                dtype=DTYPES[m.get("dtype", "bfloat16")])


def specs(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in drawing order; the names
    are the port's ``named_parameters()``."""
    z = dims(m)
    d, H, K, hd = z["d"], z["H"], z["K"], z["hd"]

    def norm(prefix):
        if z["norm"] == "layernorm":
            return [(f"{prefix}.scale", (d,), "scale"),
                    (f"{prefix}.bias", (d,), "shift")]
        return [(f"{prefix}.scale", (d,), "shift")]

    out = [("emb", (z["V"], d), "embed")]
    out += norm("final_norm")
    if not z["tie"]:
        out.append(("unemb", (d, z["V"]), "matrix"))
    for i in range(z["L"]):
        p = f"layers.{i}"
        out += norm(f"{p}.norm1")
        out += [(f"{p}.mix.wq", (d, H * hd), "matrix"),
                (f"{p}.mix.wk", (d, K * hd), "matrix"),
                (f"{p}.mix.wv", (d, K * hd), "matrix"),
                (f"{p}.mix.wo", (H * hd, d), "matrix")]
        if z["bias"]:
            out += [(f"{p}.mix.b{n}", (w,), "shift") for n, w in
                    (("q", H * hd), ("k", K * hd), ("v", K * hd), ("o", d))]
        out += norm(f"{p}.norm2")
        if z["E"]:
            E, fe = z["E"], z["fe"]
            out += [(f"{p}.moe.router", (d, E), "router"),
                    (f"{p}.moe.w_gate", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_up", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_down", (E, fe, d), "matrix")]
        else:
            out += [(f"{p}.mlp.w_gate", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_up", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_down", (z["f"], d), "matrix")]
    return out


def cache_row_bytes(z: dict) -> int:
    """Bytes one cached token takes over every layer: its K and V rows."""
    return 2 * z["L"] * z["K"] * z["hd"] * z["dtype"].itemsize


def matmul_params(z: dict) -> int:
    """Parameters one token multiplies through: the attention and MLP (or
    its ``k`` routed experts and the router) of every layer, and the
    unembedding; the embedding is a lookup."""
    d, H, K, hd = z["d"], z["H"], z["K"], z["hd"]
    attn = d * (H + 2 * K) * hd + H * hd * d
    mix = (z["k"] * 3 * d * z["fe"] + d * z["E"]) if z["E"] else 3 * d * z["f"]
    return z["L"] * (attn + mix) + d * z["V"]


def attention_flops(z: dict, pairs: float) -> float:
    """Operations of ``pairs`` (query, key) pairs over every layer."""
    return 4.0 * z["H"] * z["hd"] * z["L"] * pairs


def decode_attention_bytes(z: dict, rows: float, queries: int) -> float:
    """Bytes of decode attention over every layer: ``rows`` valid K/V rows
    read (summed over the active slots of every step) and ``queries``
    query rows read and output rows written, two-byte elements."""
    K, H, hd = z["K"], z["H"], z["hd"]
    return 2.0 * z["L"] * (2 * K * hd * rows + 2 * H * hd * queries)


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
    return rmsnorm(w(f"{prefix}.scale"), x)


def rmsnorm(offset, x):
    """``x * (1 + offset)`` over x's root mean square (eps 1e-6)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + offset)


def rotary(x, positions, rd, theta):
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


def causal_attention(q, k, v, sqrt_d):
    """softmax(q k / sqrt_d) v under a causal mask; q, k [S, heads, hd_qk],
    v [S, heads, hd_v] -> [S, heads, hd_v]."""
    S = q.shape[0]
    s = torch.einsum("qhd,khd->hqk", q, k) / sqrt_d
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


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
    q = rotary(q.view(S, H, hd), positions, rd, z["theta"])
    k = rotary(k.view(S, K, hd), positions, rd, z["theta"])
    v = v.view(S, K, hd)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    o = causal_attention(q, k, v, math.sqrt(hd))
    y = act(o.reshape(S, H * hd)) @ w(f"{p}.mix.wo")
    return y + w(f"{p}.mix.bo") if z["bias"] else y


def swiglu(x, wg, wu, wd, act):
    x = act(x)
    return act(F.silu(x @ wg) * (x @ wu)) @ wd


def experts(x, idx, weights, wg, wu, wd, act):
    """Each token's chosen experts' SwiGLU outputs summed with their
    weights: ``idx``, ``weights`` [S, k]; the experts stacked [E, ...]."""
    y = torch.zeros_like(x)
    for e in range(wg.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y.index_add_(0, tok, swiglu(x[tok], wg[e], wu[e], wd[e], act)
                         * weights[tok, slot, None])
    return y


def _moe(z, w, p, x, act):
    gates = torch.softmax(x @ w(f"{p}.moe.router"), -1)
    top, idx = gates.topk(z["k"], dim=-1)
    top = top / (top.sum(-1, keepdim=True) + 1e-9)
    return experts(x, idx, top, *(w(f"{p}.moe.{n}") for n in
                                  ("w_gate", "w_up", "w_down")), act)


def _same(x):
    return x


@torch.no_grad()
def logits(z: dict, weight, tokens: torch.Tensor, at: torch.Tensor,
           act=_same) -> torch.Tensor:
    """float32 logits [len(at), V] at positions ``at`` of one causal pass
    over ``tokens`` [S], with TF32 off.  ``weight(name)`` gives a
    parameter as float32; ``act`` is applied to every input of a product
    with a weight (the control passes lower-precision values, widened to
    float32, to both)."""
    no_tf32()
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
            h = h + swiglu(x, weight(f"{p}.mlp.w_gate"),
                           weight(f"{p}.mlp.w_up"), weight(f"{p}.mlp.w_down"),
                           act)
    h = act(_norm(z, weight, "final_norm", h[at]))
    return h @ (weight("emb").T if z["tie"] else weight("unemb"))
