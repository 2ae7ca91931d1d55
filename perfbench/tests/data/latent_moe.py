"""A test-only reference module (``perfbench/lib/describe.py``'s contract)
for a small decoder with layers ``reference/lm.py`` does not describe: a
low-rank latent K/V (``x Wdkv``, RMS-normed at the latent's own width,
then widened to every head's K and V, the latent alone cached), and a
mixture of experts routed by sigmoid scores with a shared expert beside
the routed ones.  It runs no program: the plug test drives it through
the harness's generic code.

Per layer: RMSNorm offsets ``norm1``/``norm2`` (width d),
``attn.wq [d, H hd]``, ``attn.w_dkv [d, r]``, ``attn.kv_norm [r]``,
``attn.w_uk``/``attn.w_uv [r, H hd]``, ``attn.wo [H hd, d]``, rotary on
every feature of q and k; ``moe.router [d, E]``, the experts
``moe.w_gate``/``w_up [E, d, fe]``, ``moe.w_down [E, fe, d]``: the top
``k`` of ``sigmoid(x R)``, renormalised by their sum; the shared expert
``moe.shared_gate``/``shared_up [d, fs]``, ``moe.shared_down [fs, d]``
added to every token.  A final norm and an untied unembedding.
"""
from __future__ import annotations

import math

import torch

from perfbench.lib.weights import DTYPES
from perfbench.reference import lm


def dims(m: dict) -> dict:
    return dict(d=m["d_model"], H=m["n_heads"], hd=m["head_dim"],
                r=m["kv_rank"], L=m["n_layers"], V=m["vocab"],
                E=m["n_experts"], k=m["top_k"], fe=m["d_ff_expert"],
                fs=m["d_ff_shared"], theta=m.get("rope_theta", 10000.0),
                dtype=DTYPES[m.get("dtype", "bfloat16")])


def specs(m: dict) -> list[tuple[str, tuple, str]]:
    z = dims(m)
    d, Hh, r, E, fe, fs = z["d"], z["H"] * z["hd"], z["r"], z["E"], z["fe"], z["fs"]
    out = [("emb", (z["V"], d), "embed"), ("final_norm.scale", (d,), "shift"),
           ("unemb", (d, z["V"]), "matrix")]
    for i in range(z["L"]):
        p = f"layers.{i}"
        out += [(f"{p}.norm1.scale", (d,), "shift"),
                (f"{p}.attn.wq", (d, Hh), "matrix"),
                (f"{p}.attn.w_dkv", (d, r), "matrix"),
                (f"{p}.attn.kv_norm", (r,), "shift"),
                (f"{p}.attn.w_uk", (r, Hh), "matrix"),
                (f"{p}.attn.w_uv", (r, Hh), "matrix"),
                (f"{p}.attn.wo", (Hh, d), "matrix"),
                (f"{p}.norm2.scale", (d,), "shift"),
                (f"{p}.moe.router", (d, E), "router"),
                (f"{p}.moe.w_gate", (E, d, fe), "matrix"),
                (f"{p}.moe.w_up", (E, d, fe), "matrix"),
                (f"{p}.moe.w_down", (E, fe, d), "matrix"),
                (f"{p}.moe.shared_gate", (d, fs), "matrix"),
                (f"{p}.moe.shared_up", (d, fs), "matrix"),
                (f"{p}.moe.shared_down", (fs, d), "matrix")]
    return out


def cache_row_bytes(z: dict) -> int:
    """The latent row of every layer."""
    return z["L"] * z["r"] * z["dtype"].itemsize


def matmul_params(z: dict) -> int:
    d, Hh, r = z["d"], z["H"] * z["hd"], z["r"]
    attn = d * Hh + d * r + 2 * r * Hh + Hh * d
    mix = z["k"] * 3 * d * z["fe"] + d * z["E"] + 3 * d * z["fs"]
    return z["L"] * (attn + mix) + d * z["V"]


def attention_flops(z: dict, pairs: float) -> float:
    return 4.0 * z["H"] * z["hd"] * z["L"] * pairs


def decode_attention_bytes(z: dict, rows: float, queries: int) -> float:
    """The cached latent rows read, the queries read and the outputs
    written, over every layer."""
    b = z["dtype"].itemsize
    return float(z["L"] * b * (z["r"] * rows + 2 * z["H"] * z["hd"] * queries))


def _attention(z, w, p, x, positions, act):
    S, H, hd = x.shape[0], z["H"], z["hd"]
    xa = act(x)
    c = act(lm.rmsnorm(w(f"{p}.attn.kv_norm"), xa @ w(f"{p}.attn.w_dkv")))
    q = lm.rotary((xa @ w(f"{p}.attn.wq")).view(S, H, hd), positions, hd, z["theta"])
    k = lm.rotary((c @ w(f"{p}.attn.w_uk")).view(S, H, hd), positions, hd, z["theta"])
    v = (c @ w(f"{p}.attn.w_uv")).view(S, H, hd)
    o = lm.causal_attention(q, k, v, math.sqrt(hd))
    return act(o.reshape(S, H * hd)) @ w(f"{p}.attn.wo")


def _moe(z, w, p, x, act):
    scores = torch.sigmoid(x @ w(f"{p}.moe.router"))
    top, idx = scores.topk(z["k"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = lm.experts(x, idx, top, *(w(f"{p}.moe.{n}") for n in
                                  ("w_gate", "w_up", "w_down")), act)
    return y + lm.swiglu(x, w(f"{p}.moe.shared_gate"), w(f"{p}.moe.shared_up"),
                         w(f"{p}.moe.shared_down"), act)


@torch.no_grad()
def logits(z: dict, weight, tokens: torch.Tensor, at: torch.Tensor,
           act=lambda x: x) -> torch.Tensor:
    lm.no_tf32()
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    h = weight("emb")[tokens]
    for i in range(z["L"]):
        p = f"layers.{i}"
        h = h + _attention(z, weight, p, lm.rmsnorm(weight(f"{p}.norm1.scale"), h),
                           positions, act)
        h = h + _moe(z, weight, p, lm.rmsnorm(weight(f"{p}.norm2.scale"), h), act)
    h = act(lm.rmsnorm(weight("final_norm.scale"), h[at]))
    return h @ weight("unemb")
