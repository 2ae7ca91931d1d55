"""The attention pieces DistilBERT uses, ported from
``repro.models.attention``.

Layout convention, as the reference: activations are [B, S, D];
per-head tensors are [B, S, H, hd] ("BSHD").  Attention here is plain
``torch.einsum`` with an additive f32 bias and an f32 softmax — the
reference's einsum path, not one of its Pallas kernels.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.nn import param, dense_init_

NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaN from (-inf) - (-inf)


class AttnParams(nn.Module):
    """``wq/wk/wv/wo`` (``[d_in, d_out]``) plus optional biases."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, *, bias: bool = False, device=None):
        super().__init__()
        self.wq = param(d_model, n_heads * head_dim, device=device)
        self.wk = param(d_model, n_kv * head_dim, device=device)
        self.wv = param(d_model, n_kv * head_dim, device=device)
        self.wo = param(n_heads * head_dim, d_model, device=device)
        self.has_bias = bias
        if bias:
            self.bq = param(n_heads * head_dim, device=device)
            self.bk = param(n_kv * head_dim, device=device)
            self.bv = param(n_kv * head_dim, device=device)
            self.bo = param(d_model, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)
        if self.has_bias:
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv, self.bo):
                    b.zero_()


def project_qkv(p: AttnParams, x: torch.Tensor, n_heads: int, n_kv: int,
                head_dim: int):
    """Project to q [B,S,H,hd], k/v [B,S,K,hd]."""
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.has_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def out_proj(p: AttnParams, o: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = o.shape
    y = o.reshape(B, S, H * hd) @ p.wo
    if p.has_bias:
        y = y + p.bo
    return y


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor | None = None,
           scale: float | None = None) -> torch.Tensor:
    """Masked GQA attention: q [B,Sq,H,hd], k/v [B,Skv,K,hd] (H = K*G)
    -> [B,Sq,H,hd].  ``bias`` broadcasts against the scores
    [B,K,G,Sq,Skv]; ``None`` is the all-visible mask (the reference adds
    zeros there, which changes no bit)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", (qg * scale).float(), k.float())
    if bias is not None:
        while bias.dim() < s.dim():
            bias = bias[None]
        s = s + bias
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, K * G, hd).to(q.dtype)
