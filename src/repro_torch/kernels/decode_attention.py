"""Flash-decode — one new token per slot against a contiguous KV cache
or a paged block pool.

``decode_attention(q, k, v, kv_pos, cur_pos, window=)``: q [B,H,hd];
k/v [B,K,S,hd]; kv_pos [B,S] int32 (absolute position of each cache
row, -1 = empty); cur_pos [B] int32 -> [B,H,hd] in q's dtype, the port
of ``repro.kernels.decode_attention.decode_attention``:

  - on CUDA tensors it launches the hand-written Hopper kernel
    ``csrc/decode_attention.cu`` (split-span flash-decode: one block per
    slot, kv head, group of query heads and span of ``span_rows(hd)``
    logical rows, in one of three bodies that ``decode_body`` names: at
    hd <= 128 and G = H / K = 1 one query head a block, the valid rows
    spread over all eight warps; at hd <= 128 and G > 1 every query
    head of a kv head (up to 16) in one block, each warp streaming its
    valid rows through its own ring of shared-memory tiles by
    ``cp.async``; above hd 128, up to 16 query heads of a kv head in
    one block, the span's rows copied to shared memory and worked in
    32-row tiles with register-tiled products; a cache longer than one
    span writes per-span partials to scratch that a second small kernel
    merges in span order; see the source for its bound and design) and
    adds one to ``launches`` per call (and one to ``gqa_launches`` when
    the GQA body runs, one to ``combine_launches`` when the merge
    runs); on a card that is not sm_90 it raises;
  - on CPU tensors it runs ``decode_attention_plain``, the plain
    PyTorch version of ``repro.kernels.ref.decode_attention``, which
    ``chip_smoke.py`` also holds the kernel against on the card.

q and k/v may differ in dtype (f32 or bf16 each: the model's f32
params meet its default bf16 cache); the math is f32.  Every tensor is
read through its strides, so the model's BSHD cache [B,C,K,hd] goes in
as a transposed view, read in place.  A slot with no valid row gives
0 here, the mean of its rows in the TPU kernel and of all rows in the
plain version: nothing reads such a row's output, and comparisons skip
it.  There is no fall back: a build or launch failure raises.

``paged_decode_attention(q, k_pool, v_pool, block_table, kv_pos,
cur_pos, window=)``: the same function over a shared pool
k/v [NB, bs, K, hd], where ``block_table`` [B, MB] int32 maps slot b's
logical block j to a pool block and kv_pos [B, C] (C = n * bs,
n <= MB) holds the positions of the logical rows; the port of
``repro.kernels.decode_attention.paged_decode_attention``:

  - on CUDA tensors it launches the same kernel body with the paged row
    address (the pool read in place through the table, no gathered
    copy) and adds one to ``paged_launches``;
  - on CPU tensors it runs ``paged_decode_attention_plain``:
    ``gather_block_views`` then ``decode_attention_plain``, what
    ``repro.kernels.ops.paged_decode_attention`` computes off the TPU.

``paged_decode_attention_shim`` is the gather followed by the
contiguous kernel, the table-native kernel's parity oracle: the two
walk the same logical rows with the same arithmetic, so they give the
same bytes for any block size (the reference's native == shim at
``k_blk == bs``).  The spans and the kernel's schedule are functions of
the logical row index alone, so a cache of one span and the same rows
in a mostly empty cache of many spans give the same bytes too
(``decode_span_plan`` says how a call is split).  Table entries are
not range-checked on the card (that would cost a host sync): the
allocator keeps them in range, and the plain version raises on one
that is not.

``decode_attention_chunk(q, k, v, kv_pos, start, window=)``: n new
tokens per slot against a contiguous cache, the speculative verify
chunk: q [B,n,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; start [B] int32 ->
[B,n,H,hd], query row j of slot b at position ``start[b] + j``.  The
reference has no kernel here (its ``chunk_attend`` is einsum); this
entry is the port's own, on the same body as ``decode_attention``, so
that the verify attends with step decode's numerics:

  - on CUDA tensors it launches the body over the B * n query rows,
    each row through the same code as a single query at its position,
    so row j equals ``decode_attention_cuda`` at ``cur = start + j``
    over the same cache byte for byte; it adds one to
    ``chunk_launches`` per call (and one to ``combine_launches`` when
    the span merge runs);
  - on CPU tensors it runs ``decode_attention_chunk_plain``:
    ``decode_attention_plain`` over the B * n query rows.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_kernel_tensors

# kernel calls since the last reset, contiguous, paged and chunk (a split
# call counts once), launches of the span merge, and calls of any entry
# that ran the GQA body; ``chip_smoke.py`` zeroes them before it drives the
# main path and reads them after.  A CUDA graph made by
# ``kernels.graphs.CountedGraph`` adds its launches at every replay.
launches = 0
paged_launches = 0
chunk_launches = 0
combine_launches = 0
gqa_launches = 0
COUNTERS = ("launches", "paged_launches", "chunk_launches",
            "combine_launches", "gqa_launches")

SPAN = 1024              # logical rows per span at hd <= 128: kSpan of the
SPAN_WIDE = 128          # CUDA source; and above (kSpanWide)

NEG_INF = -2.0 ** 30     # repro.kernels.ref's mask value
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def valid_rows(kv_pos, cur_pos, window: int = 0) -> torch.Tensor:
    """[B,S] bool: the cache rows slot b's query may attend to."""
    cur = cur_pos[:, None]
    ok = (kv_pos >= 0) & (kv_pos <= cur)
    if window:
        ok &= cur - kv_pos < window
    return ok


def decode_attention_plain(q, k, v, kv_pos, cur_pos, *,
                           window: int = 0) -> torch.Tensor:
    """q [B,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; cur_pos [B] ->
    [B,H,hd]: f32 scores, masked with -2**30, softmax, f32 weighted
    sum, cast to q's dtype — what ``repro.kernels.ref.decode_attention``
    computes."""
    B, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float())
    ok = valid_rows(kv_pos, cur_pos, window)
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


class SpanPlan(NamedTuple):
    """How the kernel splits a call: ``spans`` blocks along the rows,
    the f32 scratch [B, H, spans, hd + 2] (per span: acc, max, sum) or
    None, and whether the span merge runs as a second launch."""
    spans: int
    scratch_shape: tuple | None
    combine: bool


def span_rows(hd: int) -> int:
    """The logical rows of a span, a function of the head dim alone:
    ``SPAN`` for the narrow and GQA bodies (hd <= 128), ``SPAN_WIDE``
    for the wide one."""
    return SPAN if hd <= 128 else SPAN_WIDE


def decode_body(H: int, K: int, hd: int) -> str:
    """The body a call runs, as ``launch()`` of the CUDA source picks it:
    ``"wide"`` above hd 128, else ``"narrow"`` (one query head a block)
    at G = H / K = 1 and ``"gqa"`` (every query head of a kv head) at
    G > 1."""
    if hd > 128:
        return "wide"
    return "narrow" if H == K else "gqa"


def decode_span_plan(B: int, H: int, S: int, hd: int) -> SpanPlan:
    """The split of a decode call over S logical rows: one span (the
    kernel writes ``out`` itself: one launch, no scratch) up to S =
    ``span_rows(hd)``, else ceil(S / span_rows(hd)) spans merged by the
    combine kernel.  The same for both layouts (S is the logical
    extent)."""
    spans = max(1, -(-S // span_rows(hd)))
    if spans == 1:
        return SpanPlan(1, None, False)
    return SpanPlan(spans, (B, H, spans, hd + 2), True)


def _check_rows16(what: str, tensors: dict) -> None:
    """The kernel reads K/V rows in 16-byte chunks: every stride but the
    last a multiple of 16 bytes."""
    for name, t in tensors.items():
        if any(st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{what}: {name}'s strides must be multiples "
                             f"of 16 bytes, got {t.stride()} elements of "
                             f"{t.element_size()} bytes")


def _scratch(plan: SpanPlan, device) -> torch.Tensor | None:
    if plan.scratch_shape is None:
        return None
    return torch.empty(plan.scratch_shape, dtype=torch.float32,
                       device=device)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/decode_attention.cu``, built on first use, with its C
    signatures."""
    lib = build.load("decode_attention")
    for tq in _TYPES.values():
        for tkv in _TYPES.values():
            fn = getattr(lib, f"decode_attention_{tq}_{tkv}")
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_int64] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"paged_decode_attention_{tq}_{tkv}")
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_int64] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"decode_attention_chunk_{tq}_{tkv}")
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_int64] * 14
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    lib.decode_attention_span_rows.argtypes = [ctypes.c_int]
    lib.decode_attention_span_rows.restype = ctypes.c_int
    for hd in (128, 256):
        if lib.decode_attention_span_rows(hd) != span_rows(hd):
            raise RuntimeError(f"decode_attention.cu splits at "
                               f"{lib.decode_attention_span_rows(hd)} rows "
                               f"at hd {hd}, the wrapper at "
                               f"{span_rows(hd)}")
    return lib


def _check_contiguous_args(what, q, k, v, kv_pos, cur_pos, window,
                           q_dims: int) -> None:
    """The contiguous entries' checks: q [B,H,hd] (``q_dims`` 3) or
    [B,n,H,hd] (4) against k/v [B,K,S,hd], kv_pos [B,S], cur_pos or
    start [B]."""
    check_kernel_tensors(what, {"q": q, "k": k, "v": v}, dtypes=_TYPES,
                         align=True)
    _check_rows16(what, {"k": k, "v": v})
    check_kernel_tensors(what, {"kv_pos": kv_pos, "cur_pos": cur_pos},
                         dtypes={torch.int32}, align=False, device=q.device)
    shape = "[B,H,hd]" if q_dims == 3 else "[B,n,H,hd]"
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what} needs q {shape} and k/v [B,K,S,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    K, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not agree on batch, head_dim or heads (H % K)")
    if tuple(kv_pos.shape) != (B, S) or tuple(cur_pos.shape) != (B,):
        raise ValueError(f"kv_pos must be [B,S] = {(B, S)} and the "
                         f"positions [B], got {tuple(kv_pos.shape)}, "
                         f"{tuple(cur_pos.shape)}")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256], "
                         f"got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention_cuda(q, k, v, kv_pos, cur_pos, *,
                          window: int = 0) -> torch.Tensor:
    """The CUDA kernel; raises unless every tensor lies on one sm_90
    card, q and k/v are f32 or bf16 with 16-byte aligned rows (k/v
    strides multiples of 16 bytes), kv_pos
    and cur_pos are int32, hd is a multiple of 8 up to 256 and H a
    multiple of K."""
    global launches, combine_launches, gqa_launches
    _check_contiguous_args("decode attention", q, k, v, kv_pos, cur_pos,
                           window, 3)
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    cur_pos = cur_pos.contiguous()
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    lib = _library()
    fn = getattr(lib, f"decode_attention_{_TYPES[q.dtype]}_"
                      f"{_TYPES[k.dtype]}")
    plan = decode_span_plan(B, H, S, hd)
    part = _scratch(plan, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
                 B, H, K, S, hd, *q.stride()[:2], *k.stride()[:3],
                 *v.stride()[:3], *kv_pos.stride(), *out.stride()[:2],
                 1.0 / math.sqrt(hd), int(window), plan.spans,
                 None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    launches += 1
    combine_launches += plan.combine
    gqa_launches += decode_body(H, K, hd) == "gqa"
    return out


def decode_attention(q, k, v, kv_pos, cur_pos, *,
                     window: int = 0) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_pos, cur_pos,
                                      window=window)
    return decode_attention_cuda(q, k, v, kv_pos, cur_pos, window=window)


# ---------------------------------------------------------------------------
# the verify chunk: n query rows per slot
# ---------------------------------------------------------------------------

def chunk_positions(start: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] int32: query row j of slot b sits at ``start[b] + j``."""
    return (start.long()[:, None]
            + torch.arange(n, device=start.device)).to(torch.int32)


def decode_attention_chunk_plain(q, k, v, kv_pos, start, *,
                                 window: int = 0) -> torch.Tensor:
    """q [B,n,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; start [B] ->
    [B,n,H,hd]: ``decode_attention_plain`` over the B * n query rows,
    each with its slot's cache and its own position."""
    B, n, H, hd = q.shape
    cur = chunk_positions(start, n).reshape(B * n)
    o = decode_attention_plain(
        q.reshape(B * n, H, hd), k.repeat_interleave(n, dim=0),
        v.repeat_interleave(n, dim=0), kv_pos.repeat_interleave(n, dim=0),
        cur, window=window)
    return o.reshape(B, n, H, hd)


def decode_attention_chunk_cuda(q, k, v, kv_pos, start, *,
                                window: int = 0) -> torch.Tensor:
    """The CUDA kernel over the B * n query rows; raises as
    ``decode_attention_cuda`` does (q [B,n,H,hd]; start [B] int32)."""
    global chunk_launches, combine_launches, gqa_launches
    _check_contiguous_args("decode attention chunk", q, k, v, kv_pos, start,
                           window, 4)
    B, n, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    start = start.contiguous()
    out = torch.empty(B, n, H, hd, dtype=q.dtype, device=q.device)
    if B == 0 or n == 0 or H == 0:
        return out
    lib = _library()
    fn = getattr(lib, f"decode_attention_chunk_{_TYPES[q.dtype]}_"
                      f"{_TYPES[k.dtype]}")
    plan = decode_span_plan(B * n, H, S, hd)
    part = _scratch(plan, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_pos.data_ptr(), start.data_ptr(), out.data_ptr(),
                 B, n, H, K, S, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *kv_pos.stride(), *out.stride()[:3],
                 1.0 / math.sqrt(hd), int(window), plan.spans,
                 None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode attention chunk kernel launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    chunk_launches += 1
    combine_launches += plan.combine
    gqa_launches += decode_body(H, K, hd) == "gqa"
    return out


def decode_attention_chunk(q, k, v, kv_pos, start, *,
                           window: int = 0) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return decode_attention_chunk_plain(q, k, v, kv_pos, start,
                                            window=window)
    return decode_attention_chunk_cuda(q, k, v, kv_pos, start, window=window)


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

def gather_block_views(k_pool, v_pool, block_table, n_ctx: int):
    """Each slot's mapped blocks as its contiguous logical view: pool
    [NB, bs, K, hd] + table [B, MB] -> k/v [B, n_ctx, K, hd] (BSHD).
    The ONE implementation of the table gather in the port: the plain
    version, the shim and the model's ``attention.paged_gather`` all
    go through it.  Raises, with the reference's messages, when n_ctx
    is not a multiple of bs or needs more blocks than the table maps."""
    B = block_table.shape[0]
    bs = k_pool.shape[1]
    if n_ctx % bs != 0:
        raise ValueError(
            f"paged gather: logical extent n_ctx={n_ctx} is not a "
            f"multiple of the pool block size bs={bs} (pool "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)}) "
            f"— the trailing n_ctx % bs = {n_ctx % bs} rows would be "
            f"silently truncated")
    n_blocks = n_ctx // bs
    if n_blocks > block_table.shape[1]:
        raise ValueError(
            f"paged gather: n_ctx={n_ctx} needs {n_blocks} blocks of "
            f"bs={bs} rows but the block table maps only "
            f"{block_table.shape[1]} per slot (table "
            f"{tuple(block_table.shape)})")
    tb = block_table[:, :n_blocks].long()
    k = k_pool[tb].reshape(B, n_ctx, *k_pool.shape[2:])
    v = v_pool[tb].reshape(B, n_ctx, *v_pool.shape[2:])
    return k, v


def paged_decode_attention_plain(q, k_pool, v_pool, block_table, kv_pos,
                                 cur_pos, *, window: int = 0) -> torch.Tensor:
    """The gather, then ``decode_attention_plain`` on the gathered view."""
    k, v = gather_block_views(k_pool, v_pool, block_table, kv_pos.shape[1])
    return decode_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                  kv_pos, cur_pos, window=window)


def paged_decode_attention_shim(q, k_pool, v_pool, block_table, kv_pos,
                                cur_pos, *, window: int = 0) -> torch.Tensor:
    """The gather, then the contiguous CUDA kernel (which counts its
    launch in ``launches``): the parity oracle of the paged kernel, one
    extra pass over the mapped rows."""
    k, v = gather_block_views(k_pool, v_pool, block_table, kv_pos.shape[1])
    return decode_attention_cuda(q, k.transpose(1, 2), v.transpose(1, 2),
                                 kv_pos, cur_pos, window=window)


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, kv_pos,
                                cur_pos, *, window: int = 0) -> torch.Tensor:
    """The CUDA kernel over the pool in place; raises unless every tensor
    lies on one sm_90 card, q and the pools are f32 or bf16 with
    16-byte aligned rows laid out block after block, the table, kv_pos
    and cur_pos are int32, hd is a multiple of 8 up to 256, H a
    multiple of K, and the logical extent a multiple of the block size
    that the table covers."""
    global paged_launches, combine_launches, gqa_launches
    what = "paged decode attention"
    check_kernel_tensors(what, {"q": q, "k_pool": k_pool, "v_pool": v_pool},
                         dtypes=_TYPES, align=True)
    _check_rows16(what, {"k_pool": k_pool, "v_pool": v_pool})
    check_kernel_tensors(what, {"block_table": block_table,
                                "kv_pos": kv_pos, "cur_pos": cur_pos},
                         dtypes={torch.int32}, align=False, device=q.device)
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{what} needs q [B,H,hd] and k/v pools "
                         f"[NB,bs,K,hd], got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, hd = q.shape
    _, bs, K, _ = k_pool.shape
    if k_pool.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and pool "
                         f"{tuple(k_pool.shape)} do not agree on head_dim "
                         f"or heads (H % K)")
    NB = k_pool.shape[0]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if NB > 1 and t.stride(0) != bs * t.stride(1):
            raise ValueError(f"{what}: {name}'s blocks must lie back to "
                             f"back (stride(0) == bs * stride(1)), got "
                             f"strides {t.stride()}")
    if NB * bs >= 2 ** 31:
        raise ValueError(f"{what}: a pool of {NB} x {bs} rows needs row "
                         f"indices past int32")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B, MB] with B = {B}, got "
                         f"{tuple(block_table.shape)}")
    C = kv_pos.shape[1] if kv_pos.dim() == 2 else -1
    if tuple(kv_pos.shape) != (B, C) or tuple(cur_pos.shape) != (B,):
        raise ValueError(f"kv_pos must be [B, C] with B = {B} and cur_pos "
                         f"[B], got {tuple(kv_pos.shape)}, "
                         f"{tuple(cur_pos.shape)}")
    if bs == 0 or C % bs != 0:
        raise ValueError(
            f"paged decode: kv_pos extent C={C} is not a multiple of "
            f"the pool block size bs={bs} — the paged layout is "
            f"block-aligned by construction, so this is a caller bug")
    if C // bs > block_table.shape[1]:
        raise ValueError(
            f"paged decode: kv_pos extent C={C} needs {C // bs} blocks of "
            f"bs={bs} rows but the block table maps only "
            f"{block_table.shape[1]} per slot")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256], "
                         f"got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    cur_pos = cur_pos.contiguous()
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    lib = _library()
    fn = getattr(lib, f"paged_decode_attention_{_TYPES[q.dtype]}_"
                      f"{_TYPES[k_pool.dtype]}")
    plan = decode_span_plan(B, H, C, hd)
    part = _scratch(plan, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), kv_pos.data_ptr(),
                 cur_pos.data_ptr(), out.data_ptr(), B, H, K, C, hd, bs,
                 *q.stride()[:2], *k_pool.stride()[1:3],
                 *v_pool.stride()[1:3], *block_table.stride(),
                 *kv_pos.stride(), *out.stride()[:2],
                 1.0 / math.sqrt(hd), int(window), plan.spans,
                 None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    paged_launches += 1
    combine_launches += plan.combine
    gqa_launches += decode_body(H, K, hd) == "gqa"
    return out


def paged_decode_attention(q, k_pool, v_pool, block_table, kv_pos, cur_pos,
                           *, window: int = 0) -> torch.Tensor:
    """The paged CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                            kv_pos, cur_pos, window=window)
    return paged_decode_attention_cuda(q, k_pool, v_pool, block_table,
                                       kv_pos, cur_pos, window=window)
