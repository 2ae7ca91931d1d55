"""Latent decode — MLA's absorbed single-token attention over the latent
cache.

``latent_decode(q_lat, q_rope, c_kv, k_rope, kv_pos, pos, scale=)``:
q_lat [B,1,H,r] (``w_uk`` absorbed into the query), q_rope [B,1,H,rope];
the cache c_kv [B,C,r] and k_rope [B,C,rope] in its own dtype; kv_pos
[B,C] int32 (the absolute position each row holds, -1 = empty); ``pos``
the query's position, a scalar (lockstep) or [B] (continuous batching)
-> o_lat [B,1,H,r] float32: the softmax over the rows with
``0 <= kv_pos <= pos`` of ``scale * (q_lat . c_kv + q_rope . k_rope)``,
weighting the latent rows ``c_kv``.  ``models.mla.mla_decode`` applies
``w_uv`` and ``wo`` around it.

  - on CUDA tensors it launches the hand-written Hopper kernel
    ``csrc/latent_decode.cu`` (one block per slot and span of ``SPAN``
    rows, every head of the slot in the block, the live bf16 rows read
    in place once; bf16 products on the tensor cores with the weights
    kept to f32 precision; f32 operands on CUDA cores; see the source for
    its bound and design) and adds one to ``launches`` per call, and one
    to ``merge_launches`` when the cache is longer than one span (the
    merge kernel then runs); on a card that is not sm_90, or at a shape
    the kernel has no instance for, it raises;
  - on CPU tensors it runs ``latent_decode_plain``, the plain PyTorch
    version, which ``chip_smoke.py`` and the card tests hold the kernel
    against.

The kernel's instances: (r, rope) = (512, 64) with up to 16 heads
(Moonlight) and (256, 32) with up to 48 (MiniCPM3's 40); bf16 q and
cache on the tensor cores; an f32 q or an f32 cache on CUDA cores in
f32 (q is widened to f32 first: exact).  A slot with no valid row gives
0 here and the mean of all its rows in the plain version; nothing reads
such a slot's output.  There is no fall back: a build or launch failure
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_kernel_tensors

# kernel calls since the last reset, and launches of the span merge;
# ``chip_smoke.py`` zeroes them before it drives the main path and reads
# them after.  A CUDA graph made by ``kernels.graphs.CountedGraph`` adds its
# launches at every replay.
launches = 0
merge_launches = 0
COUNTERS = ("launches", "merge_launches")

SPAN = 512               # rows a block: kSpan of the CUDA source
NEG_INF = -2.0 ** 30     # models.attention's mask value
# (r, rope) -> the most heads an instance takes
SHAPES = {(512, 64): 16, (256, 32): 48}
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def latent_decode_plain(q_lat, q_rope, c_kv, k_rope, kv_pos, pos, *,
                        scale: float) -> torch.Tensor:
    """The plain version: the cache widened to f32, every row scored,
    masked with -2**30, an f32 softmax and an f32 weighted sum — what
    ``mla_decode`` computed in einsum before the kernel, operation for
    operation."""
    c = c_kv.float()                                           # [B, C, r]
    kr = k_rope.float()                                        # [B, C, rope]
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c)
              + torch.einsum("bthe,bse->bhts", q_rope.float(), kr))
    scores = scores * scale
    cur = torch.as_tensor(pos, device=c_kv.device)
    cur = cur[:, None] if cur.dim() == 1 else cur
    valid = (kv_pos >= 0) & (kv_pos <= cur)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bsr->bthr", w, c)                # [B,1,H,r]


def spans(C: int) -> int:
    """Blocks a slot's rows are cut into: ceil(C / SPAN); above one, the
    merge kernel runs too."""
    return max(1, -(-C // SPAN))


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/latent_decode.cu``, built on first use, with its C
    signatures."""
    lib = build.load("latent_decode")
    for name in ("bf16_bf16", "f32_f32", "f32_bf16"):
        fn = getattr(lib, f"latent_decode_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.latent_decode_error_string.argtypes = [ctypes.c_int]
    lib.latent_decode_error_string.restype = ctypes.c_char_p
    lib.latent_decode_span_rows.restype = ctypes.c_int
    if lib.latent_decode_span_rows() != SPAN:
        raise RuntimeError(f"latent_decode.cu spans "
                           f"{lib.latent_decode_span_rows()} rows, the "
                           f"wrapper {SPAN}")
    return lib


def _check_args(q_lat, q_rope, c_kv, k_rope, kv_pos) -> None:
    """The shapes, dtypes and layouts the kernel takes; raises on any
    other."""
    what = "latent decode"
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("c_kv", c_kv),
                    ("k_rope", k_rope)):
        if t.dtype not in _TYPES:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    if c_kv.dtype != k_rope.dtype:
        raise TypeError(f"{what}: c_kv and k_rope must share a dtype, got "
                        f"{c_kv.dtype} and {k_rope.dtype}")
    if (q_lat.dim() != 4 or q_rope.dim() != 4 or c_kv.dim() != 3
            or k_rope.dim() != 3 or q_lat.shape[1] != 1):
        raise ValueError(f"{what} needs q_lat [B,1,H,r], q_rope [B,1,H,rope], "
                         f"c_kv [B,C,r], k_rope [B,C,rope]; got "
                         f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    B, _, H, r = q_lat.shape
    C, rope = c_kv.shape[1], k_rope.shape[2]
    if (tuple(q_rope.shape[:3]) != (B, 1, H) or c_kv.shape[0] != B
            or c_kv.shape[2] != r or tuple(k_rope.shape[:2]) != (B, C)
            or tuple(kv_pos.shape) != (B, C)):
        raise ValueError(f"{what}: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_rope {tuple(k_rope.shape)} and kv_pos "
                         f"{tuple(kv_pos.shape)} do not agree")
    most = SHAPES.get((r, rope))
    if most is None or not 0 < H <= most:
        raise ValueError(f"{what} has instances for (r, rope, heads) = "
                         f"(512, 64, <= 16) and (256, 32, <= 48), got "
                         f"({r}, {rope}, {H})")
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope)):
        if any(st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{what}: {name}'s row strides must be "
                             f"multiples of 16 bytes, got {t.stride()}")


def latent_decode_cuda(q_lat, q_rope, c_kv, k_rope, kv_pos, pos, *,
                       scale: float) -> torch.Tensor:
    """The CUDA kernel; raises unless every tensor lies on one sm_90 card,
    the operands are f32 or bf16 at an instance's (r, rope, heads), the
    cache's rows are 16-byte aligned and kv_pos is int32."""
    global launches, merge_launches
    _check_args(q_lat, q_rope, c_kv, k_rope, kv_pos)
    check_kernel_tensors("latent decode", {"c_kv": c_kv, "k_rope": k_rope},
                         dtypes=_TYPES, align=True)
    B, _, H, r = q_lat.shape
    C, rope = c_kv.shape[1], k_rope.shape[2]
    tq = torch.bfloat16 if (q_lat.dtype == q_rope.dtype == c_kv.dtype
                            == torch.bfloat16) else torch.float32
    ql = q_lat.reshape(B, H, r).to(tq).contiguous()
    qr = q_rope.reshape(B, H, rope).to(tq).contiguous()
    check_kernel_tensors("latent decode", {"q_lat": ql, "q_rope": qr},
                         dtypes=_TYPES, align=True, device=c_kv.device)
    check_kernel_tensors("latent decode", {"kv_pos": kv_pos},
                         dtypes={torch.int32}, align=False,
                         device=c_kv.device)
    cur = torch.as_tensor(pos, device=c_kv.device)
    cur = cur.to(torch.int32).expand(B).contiguous()
    out = torch.empty(B, 1, H, r, dtype=torch.float32, device=c_kv.device)
    if B == 0:
        return out
    n = spans(C)
    part_o = part_ml = None
    if n > 1:
        part_o = torch.empty(B, n, H, r, dtype=torch.float32,
                             device=c_kv.device)
        part_ml = torch.empty(B, n, H, 2, dtype=torch.float32,
                              device=c_kv.device)
    lib = _library()
    fn = getattr(lib, f"latent_decode_{_TYPES[tq]}_{_TYPES[c_kv.dtype]}")
    with torch.cuda.device(c_kv.device):
        stream = torch.cuda.current_stream(c_kv.device).cuda_stream
        err = fn(ql.data_ptr(), qr.data_ptr(), c_kv.data_ptr(),
                 k_rope.data_ptr(), kv_pos.data_ptr(), cur.data_ptr(),
                 out.data_ptr(),
                 None if part_o is None else part_o.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 B, H, C, r, rope, n, *c_kv.stride()[:2],
                 *k_rope.stride()[:2], *kv_pos.stride(), float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"latent decode kernel launch failed: "
                           f"{lib.latent_decode_error_string(err).decode()}")
    launches += 1
    merge_launches += n > 1
    return out


def latent_decode(q_lat, q_rope, c_kv, k_rope, kv_pos, pos, *,
                  scale: float, impl: str = "auto") -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (``impl="auto"``); ``"ref"`` always the plain version,
    ``"cuda"`` the kernel or raise."""
    if impl not in ("auto", "ref", "cuda"):
        raise ValueError(f"impl must be one of ('auto', 'ref', 'cuda'), "
                         f"got {impl!r}")
    if impl == "ref" or (impl == "auto" and c_kv.device.type == "cpu"):
        return latent_decode_plain(q_lat, q_rope, c_kv, k_rope, kv_pos, pos,
                                   scale=scale)
    return latent_decode_cuda(q_lat, q_rope, c_kv, k_rope, kv_pos, pos,
                              scale=scale)
