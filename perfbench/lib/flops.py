"""Operations and bytes the work needs, from the configuration's sizes
(``weights.dims``) and the lengths served, counted once: each input byte
read once and each output byte written once, whatever a kernel reads
again.  Attention counts two products of ``2 * hd`` operations per
(query, key) pair and head; a causal prompt of ``S`` tokens has ``S (S +
1) / 2`` pairs."""
from __future__ import annotations


def matmul_params(z: dict) -> int:
    """Parameters one token multiplies through: the attention and MLP (or
    its ``k`` routed experts and the router) of every layer, and the
    unembedding; the embedding is a lookup."""
    d, H, K, hd = z["d"], z["H"], z["K"], z["hd"]
    attn = d * (H + 2 * K) * hd + H * hd * d
    mix = (z["k"] * 3 * d * z["fe"] + d * z["E"]) if z["E"] else 3 * d * z["f"]
    return z["L"] * (attn + mix) + d * z["V"]


def token_flops(z: dict) -> int:
    return 2 * matmul_params(z)


def attention_flops(z: dict, pairs: float) -> float:
    """Operations of ``pairs`` (query, key) pairs over every layer."""
    return 4.0 * z["H"] * z["hd"] * z["L"] * pairs


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def decode_attention_bytes(z: dict, rows: float, queries: int) -> float:
    """Bytes of decode attention over every layer: ``rows`` valid K/V rows
    read (summed over the active slots of every step) and ``queries``
    query rows read and output rows written, two-byte elements."""
    K, H, hd = z["K"], z["H"], z["hd"]
    return 2.0 * z["L"] * (2 * K * hd * rows + 2 * H * hd * queries)

