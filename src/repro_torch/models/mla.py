"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style), ported
from ``repro.models.mla``.

The decode cache keeps only the normed latent ``c_kv`` (kv_lora_rank
features) and the rotated key part ``k_rope`` shared by every head.
Prefill and ``forward`` expand the latent to per-head keys and values
(``mla_attention``: q and k of nope + rope features, v of its own
width, scale 1/sqrt(nope + rope), causal with the reference's
``NEG_INF`` = -2**30); a decode step attends in latent space with the
up-projections absorbed into the query and the output
(``mla_decode``), its attention over the latent cache in
``kernels.latent_decode``: the hand-written kernel on the card (the
live bf16 rows read in place), the plain version (f32 scores and
weighted sum over the whole cache) on the CPU.  The reference computes
MLA in einsum outside any Pallas kernel, and the port's flash kernel
takes one head dim for q, k and v, so prefill and ``forward`` are plain
PyTorch on the card too.

Rotary angles: the functions take the reference's positions, or
``rope``, the (cos, sin) of ``nn.rope_angles(positions, qk_rope_dim,
theta)`` that a decode step computes once for all of its layers.  The
port's cache is written IN PLACE (``mla_cache_write`` returns the cache
it was given).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import latent_decode
from repro_torch.models import nn as nn_
from repro_torch.models.attention import causal_attention
from repro_torch.models.nn import param


class MLAConfig(NamedTuple):
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 10_000.0


class MLAParams(nn.Module):
    """The reference's ``mla_params`` leaves: ``w_dq`` [D, q_lora],
    ``q_norm``, ``w_uq`` [q_lora, H*(nope+rope)] (``w_uq`` [D, ...] and no
    ``w_dq`` / ``q_norm`` when q_lora_rank is 0), ``w_dkv`` [D, r+rope],
    ``kv_norm``, ``w_uk`` [r, H*nope], ``w_uv`` [r, H*v] and ``wo``
    [H*v, D]; norms f32.  The reference keeps ``w_uk`` / ``w_uv`` as
    [r, H, n]; the port stores them as the [r, H*n] matrices they are
    (fan-in r, as any reader of the layout scales a matrix), and
    ``convert`` reshapes between the two."""

    def __init__(self, d_model: int, m: MLAConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        H, r = m.n_heads, m.kv_lora_rank
        qk = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora_rank:
            self.w_dq = param(d_model, m.q_lora_rank, **kw)
            self.q_norm = nn_.RMSNorm(m.q_lora_rank, device=device)
            self.w_uq = param(m.q_lora_rank, H * qk, **kw)
        else:
            self.w_uq = param(d_model, H * qk, **kw)
        self.w_dkv = param(d_model, r + m.qk_rope_dim, **kw)
        self.kv_norm = nn_.RMSNorm(r, device=device)
        self.w_uk = param(r, H * m.qk_nope_dim, **kw)
        self.w_uv = param(r, H * m.v_head_dim, **kw)
        self.wo = param(H * m.v_head_dim, d_model, **kw)
        self.m = m

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Fan-in init of the projections, norms to zero scale."""
        for name in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"):
            w = getattr(self, name, None)
            if w is not None:
                nn_.dense_init_(w, gen)
        for norm in (getattr(self, "q_norm", None), self.kv_norm):
            if norm is not None:
                norm.reset_parameters()


def _angles(m: MLAConfig, positions, device, rope):
    if rope is not None:
        return rope
    positions = torch.as_tensor(positions, device=device)
    return nn_.rope_angles(positions, m.qk_rope_dim, m.rope_theta)


def _project_q(p: MLAParams, x: torch.Tensor, rope):
    """-> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (rotated)."""
    m = p.m
    B, S, _ = x.shape
    if m.q_lora_rank:
        q = p.q_norm(x @ p.w_dq) @ p.w_uq
    else:
        q = x @ p.w_uq
    q = q.reshape(B, S, m.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., :m.qk_nope_dim], nn_.rotate(q[..., m.qk_nope_dim:], *rope)


def _project_kv_latent(p: MLAParams, x: torch.Tensor, rope):
    """-> c_kv [B,S,r] (normed), k_rope [B,S,rope] (rotated, shared)."""
    r = p.m.kv_lora_rank
    ckr = x @ p.w_dkv
    cos, sin = rope                    # [b, S, 1, rope/2]: drop the heads
    return (p.kv_norm(ckr[..., :r]),
            nn_.rotate(ckr[..., r:], cos[:, :, 0], sin[:, :, 0]))


def _heads(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """An [r, H*n] up-projection as its [r, H, n] view."""
    return w.view(w.shape[0], n_heads, -1)


def _expand_attend(p: MLAParams, x, q_nope, q_rope, c_kv, k_rope,
                   q_offset=0):
    m = p.m
    B, S, _ = x.shape
    k_nope = torch.einsum("bsr,rhn->bshn", c_kv, _heads(p.w_uk, m.n_heads))
    v = torch.einsum("bsr,rhv->bshv", c_kv, _heads(p.w_uv, m.n_heads))
    k_rope_h = k_rope[:, :, None, :].expand(B, S, m.n_heads, m.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    o = causal_attention(q, k, v, q_offset=q_offset, scale=scale)
    return o.reshape(B, S, -1) @ p.wo


def mla_attention(p: MLAParams, x: torch.Tensor, *, q_offset: int = 0,
                  rope=None) -> torch.Tensor:
    """Full-sequence (prefill / forward) MLA with expanded K/V."""
    S = x.shape[1]
    rope = _angles(p.m, torch.arange(S) + q_offset, x.device, rope)
    q_nope, q_rope = _project_q(p, x, rope)
    c_kv, k_rope = _project_kv_latent(p, x, rope)
    return _expand_attend(p, x, q_nope, q_rope, c_kv, k_rope, q_offset)


@dataclass
class MLACache:
    """One layer's latent cache: c_kv [B, C, r] and k_rope [B, C, rope] in
    the cache dtype, pos [B, C] int32 (-1 = empty); views into a stacked
    cache."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    pos: torch.Tensor


def init_mla_cache(batch: int, max_seq: int, m: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(batch, max_seq, m.kv_lora_rank, dtype=dtype,
                         device=device),
        k_rope=torch.zeros(batch, max_seq, m.qk_rope_dim, dtype=dtype,
                           device=device),
        pos=torch.full((batch, max_seq), -1, dtype=torch.int32,
                       device=device))


def _write(cache: MLACache, c_kv, k_rope, start) -> MLACache:
    """Latents of S tokens from ``start`` (scalar or [B]) at rows
    ``pos % C``, in place; only the last C tokens when S > C (the others
    would be overwritten, and a scatter with repeated indices has no
    defined order on the card)."""
    B, C = cache.pos.shape
    S = c_kv.shape[1]
    first = max(S - C, 0)
    dev = cache.pos.device
    steps = torch.arange(first, S, device=dev)
    c_kv = c_kv[:, first:].to(cache.c_kv.dtype)
    k_rope = k_rope[:, first:].to(cache.k_rope.dtype)
    if not (isinstance(start, torch.Tensor) and start.dim() == 1):
        posn = steps + start
        idx = posn % C
        cache.c_kv[:, idx] = c_kv
        cache.k_rope[:, idx] = k_rope
        cache.pos[:, idx] = posn.to(torch.int32)
        return cache
    posn = start[:, None] + steps[None, :]                     # [B, S]
    idx = posn % C
    b = torch.arange(B, device=dev)[:, None]
    cache.c_kv[b, idx] = c_kv
    cache.k_rope[b, idx] = k_rope
    cache.pos[b, idx] = posn.to(torch.int32)
    return cache


def _positions(start, S, device):
    steps = torch.arange(S, device=device)
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        return start[:, None] + steps[None, :]                 # [B, S]
    return steps + start


def mla_cache_write(p: MLAParams, cache: MLACache, x: torch.Tensor, start,
                    *, rope=None) -> MLACache:
    """Project x's tokens to latents and write them at [start, start+S),
    in place; ``start`` scalar (lockstep) or [B] (continuous batching)."""
    rope = _angles(p.m, _positions(start, x.shape[1], x.device), x.device,
                   rope)
    c_kv, k_rope = _project_kv_latent(p, x, rope)
    return _write(cache, c_kv, k_rope, start)


def mla_prefill(p: MLAParams, cache: MLACache, x: torch.Tensor, *,
                rope=None) -> torch.Tensor:
    """``mla_attention`` plus ``mla_cache_write`` from position 0, the
    reference's prefill (``transformer.py:369-371``), the latents
    projected once for both."""
    rope = _angles(p.m, torch.arange(x.shape[1]), x.device, rope)
    q_nope, q_rope = _project_q(p, x, rope)
    c_kv, k_rope = _project_kv_latent(p, x, rope)
    _write(cache, c_kv, k_rope, 0)
    return _expand_attend(p, x, q_nope, q_rope, c_kv, k_rope)


def mla_decode(p: MLAParams, x: torch.Tensor, cache: MLACache, *, pos,
               rope=None, impl: str = "auto"
               ) -> tuple[torch.Tensor, MLACache]:
    """Absorbed single-token decode: x [B, 1, D] -> (y [B, 1, D], cache);
    ``pos`` scalar (lockstep) or [B] (continuous batching).  The attention
    over the latent cache is ``kernels.latent_decode`` under ``impl``: the
    CUDA kernel for a CUDA cache and the plain version for a CPU one
    (``"auto"``), the plain version always (``"ref"``), or the kernel or
    raise (``"cuda"``)."""
    m = p.m
    B = x.shape[0]
    rope = _angles(p.m, _positions(pos, 1, x.device), x.device, rope)
    c_kv, k_rope = _project_kv_latent(p, x, rope)
    _write(cache, c_kv, k_rope, pos)
    q_nope, q_rope = _project_q(p, x, rope)
    # W_uk absorbed into q: q_lat [B, 1, H, r]
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, _heads(p.w_uk, m.n_heads))
    o_lat = latent_decode.latent_decode(
        q_lat, q_rope, cache.c_kv, cache.k_rope, cache.pos, pos,
        scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim), impl=impl)
    o = torch.einsum("bthr,rhv->bthv", o_lat,
                     _heads(p.w_uv, m.n_heads).float())
    return o.to(x.dtype).reshape(B, 1, -1) @ p.wo, cache
