"""The plain Moonlight-16B-A3B (DeepSeek-V3 blocks without multi-token
prediction) in float32 with TF32 off: one causal pass over a whole
sequence, no cache, no kernels, no batching, each weight widened to
float32 where it is used.  A configuration names it with
``"reference": "reference/moonlight.py"``; it provides the seven
functions of ``perfbench/lib/describe.py``'s contract.

Semantics, from the published architecture in the port's parameter
layout (dense matrices ``[d_in, d_out]`` applied as ``x @ W``, experts
stacked ``[E, d_in, d_out]``, the router ``[d, E]`` and its correction
bias ``[E]`` in float32, RMSNorm's offset from 1 in float32): pre-norm
residual blocks, RMSNorm ``x * (1 + scale)`` (eps 1e-6).

- Multi-head Latent Attention in its expanded form: per head, q of
  ``nope + rope`` features from ``x Wuq`` (no low-rank q); the latent
  ``x Wdkv``'s first ``r`` features RMS-normed at width ``r``, its last
  ``rope`` the key's rotary part ``k_pe``, shared by every head; per
  head ``k_nope = c Wuk`` and ``v = c Wuv``; rotary on q's rope features
  and on ``k_pe``, by interleaved pairs ``(x[2i], x[2i+1])`` at
  frequencies ``theta ** (-2i / rope)``; softmax of ``q k / sqrt(nope +
  rope)`` under a causal mask; ``o Wo``.
- Layers below ``first_dense_layers``: a SwiGLU ``(silu(x Wg) * (x Wu))
  Wd`` of width ``d_ff``.
- The others: the scores ``s = sigmoid(x R)``; the top ``k`` experts on
  ``s + b`` (the correction bias enters the choice only); their weights
  the uncorrected ``s``, renormalised by their sum and scaled by
  ``routed_scale``; each token's chosen experts' SwiGLU outputs summed
  with those weights, no token dropped; plus a shared SwiGLU of width
  ``n_shared_experts * d_ff_expert`` that every token takes.
- A final norm and an untied unembedding.

The counts are the published arithmetic, whatever path computes it:
the expanded attention's products per (query, key) pair, the latent
row that a token caches, and each input byte read once and each output
byte written once.
"""
from __future__ import annotations

import math

import torch

from perfbench.lib.weights import DTYPES
from perfbench.reference import lm


def dims(m: dict) -> dict:
    """Sizes of a ``model`` block (the port's ``ModelConfig`` fields)."""
    return dict(d=m["d_model"], H=m["n_heads"], r=m["kv_lora_rank"],
                nope=m["qk_nope_dim"], rope=m["qk_rope_dim"],
                v=m["v_head_dim"], L=m["n_layers"], V=m["vocab"],
                f=m["d_ff"], E=m["n_experts"], k=m["top_k"],
                fe=m["d_ff_expert"], fs=m["n_shared_experts"] * m["d_ff_expert"],
                dense=m["first_dense_layers"], scale=m["routed_scale"],
                theta=m["rope_theta"], dtype=DTYPES[m.get("dtype", "bfloat16")])


def specs(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in drawing order; the names
    are the port's ``named_parameters()``."""
    z = dims(m)
    d, H, r, E, fe, fs = z["d"], z["H"], z["r"], z["E"], z["fe"], z["fs"]
    qk = z["nope"] + z["rope"]
    out = [("emb", (z["V"], d), "embed"), ("final_norm.scale", (d,), "shift"),
           ("unemb", (d, z["V"]), "matrix")]
    for i in range(z["L"]):
        p = f"layers.{i}"
        out += [(f"{p}.norm1.scale", (d,), "shift"),
                (f"{p}.mix.w_uq", (d, H * qk), "matrix"),
                (f"{p}.mix.w_dkv", (d, r + z["rope"]), "matrix"),
                (f"{p}.mix.kv_norm.scale", (r,), "shift"),
                (f"{p}.mix.w_uk", (r, H * z["nope"]), "matrix"),
                (f"{p}.mix.w_uv", (r, H * z["v"]), "matrix"),
                (f"{p}.mix.wo", (H * z["v"], d), "matrix"),
                (f"{p}.norm2.scale", (d,), "shift")]
        if i < z["dense"]:
            out += [(f"{p}.mlp.w_gate", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_up", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_down", (z["f"], d), "matrix")]
        else:
            out += [(f"{p}.moe.router", (d, E), "router"),
                    (f"{p}.moe.router_bias", (E,), "shift"),
                    (f"{p}.moe.w_gate", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_up", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_down", (E, fe, d), "matrix"),
                    (f"{p}.moe.shared_gate", (d, fs), "matrix"),
                    (f"{p}.moe.shared_up", (d, fs), "matrix"),
                    (f"{p}.moe.shared_down", (fs, d), "matrix")]
    return out


def cache_row_bytes(z: dict) -> int:
    """Bytes one cached token takes over every layer: its normed latent
    and its rotary key part."""
    return z["L"] * (z["r"] + z["rope"]) * z["dtype"].itemsize


def matmul_params(z: dict) -> int:
    """Parameters one token multiplies through: the attention's
    projections, the dense SwiGLU or the router, ``k`` routed experts and
    the shared one, of every layer, and the unembedding; the embedding is
    a lookup."""
    d, H, r = z["d"], z["H"], z["r"]
    attn = (d * H * (z["nope"] + z["rope"]) + d * (r + z["rope"])
            + r * H * (z["nope"] + z["v"]) + H * z["v"] * d)
    dense = 3 * d * z["f"]
    moe = z["k"] * 3 * d * z["fe"] + d * z["E"] + 3 * d * z["fs"]
    n_moe = z["L"] - z["dense"]
    return z["L"] * attn + z["dense"] * dense + n_moe * moe + d * z["V"]


def attention_flops(z: dict, pairs: float) -> float:
    """Operations of ``pairs`` (query, key) pairs over every layer: per
    head, ``q k`` over ``nope + rope`` features and the weighted sum over
    ``v``, two operations a product."""
    return 2.0 * z["H"] * (z["nope"] + z["rope"] + z["v"]) * z["L"] * pairs


def decode_attention_bytes(z: dict, rows: float, queries: int) -> float:
    """Bytes of decode attention over every layer: ``rows`` cached latent
    rows (latent and rotary key part) read, and ``queries`` query rows
    (every head's q) read and output rows (every head's v-wide output)
    written."""
    q_out = z["H"] * (z["nope"] + z["rope"] + z["v"])
    return float(z["L"] * z["dtype"].itemsize
                 * ((z["r"] + z["rope"]) * rows + q_out * queries))


def _attention(z, w, p, x, positions, act):
    S, H, nope, rope, r = x.shape[0], z["H"], z["nope"], z["rope"], z["r"]
    xa = act(x)
    q = (xa @ w(f"{p}.mix.w_uq")).view(S, H, nope + rope)
    ckv = xa @ w(f"{p}.mix.w_dkv")
    c = act(lm.rmsnorm(w(f"{p}.mix.kv_norm.scale"), ckv[:, :r]))
    k_pe = lm.rotary(ckv[:, None, r:], positions, rope, z["theta"])
    q = torch.cat([q[..., :nope], lm.rotary(q[..., nope:], positions, rope,
                                            z["theta"])], -1)
    k_nope = (c @ w(f"{p}.mix.w_uk")).view(S, H, nope)
    v = (c @ w(f"{p}.mix.w_uv")).view(S, H, z["v"])
    k = torch.cat([k_nope, k_pe.expand(S, H, rope)], -1)
    o = lm.causal_attention(q, k, v, math.sqrt(nope + rope))
    return act(o.reshape(S, H * z["v"])) @ w(f"{p}.mix.wo")


def _moe(z, w, p, x, act):
    s = torch.sigmoid(x @ w(f"{p}.moe.router"))
    idx = (s + w(f"{p}.moe.router_bias")).topk(z["k"], dim=-1).indices
    top = s.gather(-1, idx)
    top = top / top.sum(-1, keepdim=True) * z["scale"]
    y = lm.experts(x, idx, top, *(w(f"{p}.moe.{n}") for n in
                                  ("w_gate", "w_up", "w_down")), act)
    return y + lm.swiglu(x, w(f"{p}.moe.shared_gate"), w(f"{p}.moe.shared_up"),
                         w(f"{p}.moe.shared_down"), act)


def _same(x):
    return x


@torch.no_grad()
def logits(z: dict, weight, tokens: torch.Tensor, at: torch.Tensor,
           act=_same) -> torch.Tensor:
    """float32 logits [len(at), V] at positions ``at`` of one causal pass
    over ``tokens`` [S], with TF32 off.  ``weight(name)`` gives a
    parameter as float32; ``act`` is applied to every input of a product
    with a weight."""
    lm.no_tf32()
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    h = weight("emb")[tokens]
    for i in range(z["L"]):
        p = f"layers.{i}"
        h = h + _attention(z, weight, p, lm.rmsnorm(weight(f"{p}.norm1.scale"), h),
                           positions, act)
        x = lm.rmsnorm(weight(f"{p}.norm2.scale"), h)
        if i < z["dense"]:
            h = h + lm.swiglu(x, weight(f"{p}.mlp.w_gate"), weight(f"{p}.mlp.w_up"),
                              weight(f"{p}.mlp.w_down"), act)
        else:
            h = h + _moe(z, weight, p, x, act)
    h = act(lm.rmsnorm(weight("final_norm.scale"), h[at]))
    return h @ weight("unemb")
