"""Attention, ported from ``repro.models.attention``: the einsum path
DistilBERT and the decoder LM share, the masks, the contiguous KV cache
and the BSHD shims in front of the port's flash / flash-decode kernels.

Layout convention, as the reference: activations are [B, S, D];
per-head tensors are [B, S, H, hd] ("BSHD"); a KV cache is
[B, C, K, hd] plus an int32 position per row (-1 = empty), so a
windowed layer's cache is a ring of C = window rows.  The einsum path
(``attend``) keeps the reference's numerics: f32 scores from the
operands' own dtype, an additive f32 bias, an f32 softmax, and the
weights cast DOWN to v's dtype before an f32-accumulated weighted sum.

Unlike the reference, whose caches are immutable and rebuilt by every
write, the port writes a cache IN PLACE: ``cache_write`` and
``paged_cache_write`` update the tensors they are given and return the
same cache.

The paged pool (``init_paged_kv_cache``): k/v [NB, bs, K, hd] shared by
every slot, a per-slot LOGICAL pos [B, C] with the contiguous layout's
semantics, and a block table [B, MB] (carried on the model's
``Cache``) mapping slot b's logical block j to a pool block; unmapped
entries point at the trash block 0 and are excluded by pos, never by
the table.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.nn import param, dense_init_

NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaN from (-inf) - (-inf)


class AttnParams(nn.Module):
    """``wq/wk/wv/wo`` (``[d_in, d_out]``) plus optional biases."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, *, bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wq = param(d_model, n_heads * head_dim, **kw)
        self.wk = param(d_model, n_kv * head_dim, **kw)
        self.wv = param(d_model, n_kv * head_dim, **kw)
        self.wo = param(n_heads * head_dim, d_model, **kw)
        self.has_bias = bias
        if bias:
            self.bq = param(n_heads * head_dim, **kw)
            self.bk = param(n_kv * head_dim, **kw)
            self.bv = param(n_kv * head_dim, **kw)
            self.bo = param(d_model, **kw)

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
    """Masked GQA attention: q [B,Sq,H,hd], k [B,Skv,K,hd] (H = K*G) and
    v [B,Skv,K,hd_v] -> [B,Sq,H,hd_v] (MLA's v is narrower than its q
    and k).  ``bias`` broadcasts against the scores [B,K,G,Sq,Skv];
    ``None`` is the all-visible mask (the reference adds zeros there,
    which changes no bit).  On DTensors (a sharded step) each rank
    attends its own rows and whole GQA groups, through
    ``ops.local_call``: the score einsum would flatten a sharded head dim
    into its batch, which DTensor can only do replicated."""
    if isinstance(q, DTensor):
        from repro_torch.kernels import ops
        roles = (("b", None, "h", None), ("b", None, "kh", None),
                 ("b", None, "kh", None))
        args = (q, k, v)
        if bias is not None:     # [.., Sq, Skv], or [B, 1, 1, 1, Skv]
            batch = bias.dim() == 5 and bias.shape[0] > 1
            roles += (("b" if batch else None,) + (None,) * (bias.dim() - 1),)
            args += (bias,)
        return ops.local_call(functools.partial(attend, scale=scale), roles,
                              (("b", None, "h", None),), *args)
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
    # weights rounded to v's dtype, products summed in f32 (the
    # reference's preferred_element_type=float32)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, K * G, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# masks and full-sequence attention (prefill / forward)
# ---------------------------------------------------------------------------

def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int = 0, prefix_len=0,
              k_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Additive f32 mask [..., Sq, Skv] from absolute positions: causal
    admits k_pos <= q_pos; a window also needs q_pos - k_pos < window;
    positions < prefix_len are mutually visible (prefix-LM); ``k_valid``
    [Skv] / [B, Skv] marks valid keys."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        cau = kp <= qp
        if not isinstance(prefix_len, int) or prefix_len != 0:
            pl = torch.as_tensor(prefix_len, device=q_pos.device)
            while pl.dim() < 2:
                pl = pl[..., None]
            cau = cau | (kp < pl)
        ok = ok & cau
    if window:
        ok = ok & (qp - kp < window)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def causal_attention(q, k, v, *, q_offset: int = 0, window: int = 0,
                     prefix_len=0, q_chunk: int = 1024,
                     scale: float | None = None) -> torch.Tensor:
    """Full causal attention chunked over query blocks of ``q_chunk``,
    so the scores never exceed [B, H, q_chunk, Skv].  A window masks but
    saves no FLOPs here (``local_attention`` does)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Skv, device=q.device)
    if Sq <= q_chunk:
        bias = mask_bias(q_pos, k_pos, causal=True, window=window,
                         prefix_len=prefix_len)
        return attend(q, k, v, bias, scale)
    outs = []
    for i in range(0, Sq, q_chunk):
        bias = mask_bias(q_pos[i:i + q_chunk], k_pos, causal=True,
                         window=window, prefix_len=prefix_len)
        outs.append(attend(q[:, i:i + q_chunk], k, v, bias, scale))
    return torch.cat(outs, dim=1)


def local_attention(q, k, v, *, window: int, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked sliding-window attention, FLOPs O(S * 2 * window): the
    queries of block i attend to the keys of blocks i-1 and i under the
    causal + window mask.  The sequence is padded to a block multiple."""
    B, S, H, hd = q.shape
    w = window
    n = -(-S // w)
    pad = n * w - S

    def blockify(x):
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, w, x.shape[2], hd)

    qb, kb, vb = blockify(q), blockify(k), blockify(v)
    kprev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n]
    vprev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n]
    k2 = torch.cat([kprev, kb], dim=2)                # [B, n, 2w, K, hd]
    v2 = torch.cat([vprev, vb], dim=2)
    pos = torch.arange(n * w, device=q.device).reshape(n, w) + q_offset
    kpos = torch.cat([pos - w, pos], dim=1)            # [n, 2w]
    outs = []
    for i in range(n):
        valid = torch.cat([torch.full((w,), i > 0, device=q.device),
                           torch.ones(w, dtype=torch.bool, device=q.device)])
        bias = mask_bias(pos[i], kpos[i], causal=True, window=w,
                         k_valid=valid)
        outs.append(attend(qb[:, i], k2[:, i], v2[:, i], bias, scale))
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# the kernels, behind BSHD shims (repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

def causal_attention_kernel(q, k, v, *, window: int = 0, q_offset: int = 0,
                            impl: str = "auto") -> torch.Tensor:
    """Full causal attention through ``ops.flash_attention``.  The model
    speaks BSHD, the kernel's interface BHSD: the transposes are views
    (the CUDA kernel reads strides and writes a BSHD buffer), so nothing
    is copied at the boundary."""
    from repro_torch.kernels import ops
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window,
                            q_offset=q_offset, impl=impl)
    return o.transpose(1, 2)


def decode_attend_kernel(q, cache: "KVCache", *, pos, window: int = 0,
                         impl: str = "auto") -> torch.Tensor:
    """One-token attention through ``ops.decode_attention``: q [B,1,H,hd]
    against the cache read in place (a transposed view); ``pos`` is a
    scalar (lockstep) or [B] (continuous batching).  Same validity rule
    as :func:`decode_attend`."""
    from repro_torch.kernels import ops
    B = q.shape[0]
    cur = torch.as_tensor(pos, device=q.device)
    if cur.dtype != torch.int32 or cur.dim() == 0:
        cur = cur.to(torch.int32).expand(B).contiguous()
    o = ops.decode_attention(q[:, 0], cache.k.transpose(1, 2),
                             cache.v.transpose(1, 2), cache.pos, cur,
                             window=window, impl=impl)
    return o[:, None]


# ---------------------------------------------------------------------------
# KV cache (full or ring) and the decode step's attention
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """One layer's cache: k/v [B, C, K, hd] (C = min(max_seq, window or
    inf)) and pos [B, C] int32, the absolute position each row holds
    (-1 = empty).  The tensors may be views into a stacked cache."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int, *,
                  window: int = 0, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    C = min(max_seq, window) if window else max_seq
    return KVCache(
        k=torch.zeros(batch, C, n_kv, head_dim, dtype=dtype, device=device),
        v=torch.zeros(batch, C, n_kv, head_dim, dtype=dtype, device=device),
        pos=torch.full((batch, C), -1, dtype=torch.int32, device=device))


def cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                start) -> KVCache:
    """Write S_new tokens from absolute position ``start`` IN PLACE and
    return ``cache``.  ``start`` is a scalar (lockstep decode, prefill)
    or a [B] tensor (continuous batching: each slot at its own
    position).  Rows go to position modulo C, so a windowed cache is a
    ring.  When S_new > C only the last C tokens are written: the
    earlier ones would be overwritten anyway, and one scatter with
    repeated indices has no defined order on the card."""
    B, C = cache.k.shape[:2]
    S_new = k_new.shape[1]
    first = max(S_new - C, 0)
    dev = cache.k.device
    steps = torch.arange(first, S_new, device=dev)
    k_new = k_new[:, first:].to(cache.k.dtype)
    v_new = v_new[:, first:].to(cache.v.dtype)
    if not (isinstance(start, torch.Tensor) and start.dim() == 1):
        posn = steps + start        # [S]; an int start costs no copy
        idx = posn % C
        cache.k[:, idx] = k_new
        cache.v[:, idx] = v_new
        cache.pos[:, idx] = posn.to(torch.int32)
        return cache
    posn = start[:, None] + steps[None, :]                     # [B, S]
    idx = posn % C
    b = torch.arange(B, device=dev)[:, None]
    cache.k[b, idx] = k_new
    cache.v[b, idx] = v_new
    cache.pos[b, idx] = posn.to(torch.int32)
    return cache


def decode_attend(q: torch.Tensor, cache: KVCache, *, pos,
                  window: int = 0, scale: float | None = None):
    """One-token attention on the einsum path: q [B, 1, H, hd]; ``pos``
    is the new token's absolute position, scalar or [B]."""
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dim() == 1:
        pos = pos[:, None]                         # [B,1] vs k_pos [B,C]
    k_pos = cache.pos
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window:
        valid = valid & (pos - k_pos < window)
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, None, :]
    return attend(q, cache.k, cache.v, bias, scale)


def cache_write_chunk(cache: KVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor, start) -> KVCache:
    """Write S tokens per row at per-row absolute ``start`` positions
    WITHOUT ring wrap-around, IN PLACE, and return ``cache`` (the
    speculative write, ref ``attention.py:423-443``).

    Rows past the cache extent are CLAMPED onto the last row C-1
    instead of wrapping modulo C, so a chunk issued near the ``max_seq``
    stop never overwrites a slot's early prompt rows.  The spill row's
    ``pos`` lands >= C-1, and the engine's emission guard keeps every
    emitted query position < C-1, so it is never attended.  Several
    chunk rows may clamp onto C-1: the LAST of them wins, as in the
    reference's scatter, and every write to that row carries the last
    row's values, so the result does not hang on the order in which the
    card applies a scatter with repeated indices."""
    B, C = cache.k.shape[:2]
    S = k_new.shape[1]
    dev = cache.k.device
    start = torch.as_tensor(start, device=dev).long().expand(B)
    steps = torch.arange(S, device=dev)
    posm = start[:, None] + steps[None, :]                      # [B, S]
    idx = posm.clamp(max=C - 1)
    src = torch.where(idx == C - 1, S - 1, steps[None, :])      # the winner
    b = torch.arange(B, device=dev)[:, None]
    cache.k[b, idx] = k_new[b, src].to(cache.k.dtype)
    cache.v[b, idx] = v_new[b, src].to(cache.v.dtype)
    cache.pos[b, idx] = posm[b, src].to(torch.int32)
    return cache


def chunk_attend(q: torch.Tensor, cache: KVCache, *, qpos,
                 window: int = 0, scale: float | None = None):
    """Multi-token decode attention on the einsum path (the speculative
    verify step, ref ``attention.py:446-461``): q [B, S, H, hd] with
    per-query absolute positions ``qpos`` [B, S]; the validity rule is
    :func:`decode_attend`'s per query row, so at S == 1 this is
    ``decode_attend``."""
    qpos = torch.as_tensor(qpos, device=q.device)
    k_pos = cache.pos[:, None, :]                               # [B,1,C]
    valid = (k_pos >= 0) & (k_pos <= qpos[..., None])
    if window:
        valid = valid & (qpos[..., None] - k_pos < window)
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None]
    return attend(q, cache.k, cache.v, bias, scale)


def chunk_attend_kernel(q, cache: KVCache, *, start, window: int = 0,
                        impl: str = "auto") -> torch.Tensor:
    """The verify chunk through ``ops.decode_attention_chunk``: q
    [B,S,H,hd], query row j of slot b at ``start[b] + j``, against the
    cache read in place; on the card the flash-decode body attends each
    row as a single query at its position.  Same validity rule as
    :func:`chunk_attend`."""
    from repro_torch.kernels import ops
    B = q.shape[0]
    st = torch.as_tensor(start, device=q.device)
    if st.dtype != torch.int32 or st.dim() == 0:
        st = st.to(torch.int32).expand(B).contiguous()
    return ops.decode_attention_chunk(q, cache.k.transpose(1, 2),
                                      cache.v.transpose(1, 2), cache.pos, st,
                                      window=window, impl=impl)


# ---------------------------------------------------------------------------
# the paged pool (ref attention.py:343-421)
# ---------------------------------------------------------------------------

def init_paged_kv_cache(batch: int, logical_len: int, n_kv: int,
                        head_dim: int, *, n_blocks: int, block_size: int,
                        dtype=torch.bfloat16, device=None) -> KVCache:
    """Pool-layout cache: ``n_blocks`` x ``block_size`` rows shared by
    ``batch`` slots whose logical extent is ``logical_len`` rows."""
    shape = (n_blocks, block_size, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, logical_len), -1, dtype=torch.int32,
                       device=device))


class PagedRows(NamedTuple):
    """Where one token per slot goes in a paged pool (``paged_locate``):
    slot b writes pool row ``(blk[b], off[b])`` and, when ``inside[b]``,
    ``pos[b, col[b]] = posv[b]``."""
    b: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    col: torch.Tensor
    posv: torch.Tensor
    inside: torch.Tensor


def paged_locate(block_table: torch.Tensor, pos, block_size: int,
                 logical_len: int) -> PagedRows:
    """The rows of one decode step: ``pos`` scalar or [B]; the physical
    row is ``(block_table[b, pos_b // bs], pos_b % bs)``.  As the
    reference's gather, a logical block past the table is clamped to
    its last entry, and as its ``mode="drop"`` a position ``>= C`` is
    not written to ``pos`` (``inside`` is False there)."""
    dev = block_table.device
    B = block_table.shape[0]
    posv = torch.as_tensor(pos, device=dev)
    posv = (posv.expand(B) if posv.dim() == 0 else posv).long()
    b = torch.arange(B, device=dev)
    col = (posv // block_size).clamp(max=block_table.shape[1] - 1)
    return PagedRows(b=b, blk=block_table[b, col].long(),
                     off=posv % block_size,
                     col=posv.clamp(max=logical_len - 1),
                     posv=posv.to(torch.int32), inside=posv < logical_len)


def paged_write_rows(k_pool, v_pool, k_new, v_new, rows: PagedRows) -> None:
    """One token per slot into the pool, in place: k_new/v_new
    [B, 1, K, hd].  Retired slots still stepped inside a window point
    at the trash block, so several slots may write one row of it: a
    plain indexed write, whichever lands, since nothing reads it."""
    k_pool[rows.blk, rows.off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[rows.blk, rows.off] = v_new[:, 0].to(v_pool.dtype)


def paged_write_pos(pos: torch.Tensor, rows: PagedRows) -> None:
    """The step's positions into pos [..., B, C] (one layer, or every
    layer of a stacked cache at once), in place.  A dropped entry is
    rewritten with its own value, which needs no host sync."""
    old = pos[..., rows.b, rows.col]
    pos[..., rows.b, rows.col] = torch.where(rows.inside, rows.posv, old)


def paged_cache_write(cache: KVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor, pos, block_table: torch.Tensor,
                      block_size: int) -> KVCache:
    """Write ONE token per slot at its own absolute position, IN PLACE,
    and return ``cache`` (ref ``attention.py:355-374``): k_new/v_new
    [B, 1, K, hd]; ``pos`` scalar or [B]; see :func:`paged_locate`.
    The decoder locates a step's rows once and writes ``pos`` for all
    its layers at once, with the same functions."""
    rows = paged_locate(block_table, pos, block_size, cache.pos.shape[1])
    paged_write_rows(cache.k, cache.v, k_new, v_new, rows)
    paged_write_pos(cache.pos, rows)
    return cache


def paged_gather(cache: KVCache, block_table: torch.Tensor) -> KVCache:
    """Each slot's logical [B, C, K, hd] view of the pool as a
    contiguous-layout cache, through the kernels' one table gather."""
    from repro_torch.kernels.decode_attention import gather_block_views
    k, v = gather_block_views(cache.k, cache.v, block_table,
                              cache.pos.shape[1])
    return KVCache(k=k, v=v, pos=cache.pos)


def paged_decode_attend(q: torch.Tensor, cache: KVCache,
                        block_table: torch.Tensor, *, pos, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """One-token attention over the slot's mapped blocks on the einsum
    path: the gathered view through :func:`decode_attend`."""
    return decode_attend(q, paged_gather(cache, block_table), pos=pos,
                         window=window, scale=scale)


def paged_decode_attend_kernel(q, cache: KVCache, block_table, *, pos,
                               window: int = 0,
                               impl: str = "auto") -> torch.Tensor:
    """One-token paged attention through ``ops.paged_decode_attention``:
    on the card the table-native kernel reads the pool in place;
    ``impl="shim"`` keeps the gather oracle reachable."""
    from repro_torch.kernels import ops
    B = q.shape[0]
    cur = torch.as_tensor(pos, device=q.device)
    if cur.dtype != torch.int32 or cur.dim() == 0:
        cur = cur.to(torch.int32).expand(B).contiguous()
    o = ops.paged_decode_attention(q[:, 0], cache.k, cache.v, block_table,
                                   cache.pos, cur, window=window, impl=impl)
    return o[:, None]


# ---------------------------------------------------------------------------
# cross-attention over encoder rows (ref transformer.py:405-415, 551-566)
# ---------------------------------------------------------------------------

def cross_kv(p: AttnParams, enc_out: torch.Tensor, n_kv: int,
             head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V [B, Senc, K, hd] from the encoder's
    output [B, Senc, D]: the layer's ``wk`` / ``wv`` (and biases)."""
    B, S, _ = enc_out.shape
    k = enc_out @ p.wk
    v = enc_out @ p.wv
    if p.has_bias:
        k, v = k + p.bk, v + p.bv
    return (k.reshape(B, S, n_kv, head_dim), v.reshape(B, S, n_kv, head_dim))


def cross_attend(p: AttnParams, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, n_heads: int,
                 head_dim: int) -> torch.Tensor:
    """Decoder rows x [B, S, D] attend to every encoder row of k/v
    [B, Senc, K, hd]: no mask and no rotary (the reference's ``attend``
    with a zero bias), then the layer's out projection."""
    B, S, _ = x.shape
    q = x @ p.wq
    if p.has_bias:
        q = q + p.bq
    return out_proj(p, attend(q.reshape(B, S, n_heads, head_dim), k, v))
