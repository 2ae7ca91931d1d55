"""Causal GQA flash attention — the prefill hot spot.

``flash_attention(q, k, v, causal=, window=, q_offset=)``: q [B,H,Sq,hd],
k/v [B,K,Skv,hd] (GQA: H = K*G) -> [B,H,Sq,hd] in q's dtype, the port of
``repro.kernels.flash_attention.flash_attention``:

  - on CUDA tensors it launches the hand-written Hopper kernel
    ``csrc/flash_attention.cu`` and adds one to ``launches``; on a card
    that is not sm_90 it raises.  bf16 q, k and v (the serving
    prefill) at head dims 64, 80, 96, 128 and 256 run the tensor-core
    body: one warpgroup per 64 query rows, K/V tiles of 64 keys brought
    in by TMA, both products as ``wgmma`` with P rounded to bf16.
    Entries with an f32 operand (the f32 parity path), and bf16 at the
    other head dims (the smoke configurations' hd 32), run the CUDA-core
    body (32-row tiles, f32 products); :func:`body` says which.  See the
    source for both bounds and designs;
  - on CPU tensors it runs ``flash_attention_plain``, the plain PyTorch
    version of ``repro.kernels.ref.flash_attention``, which
    ``chip_smoke.py`` also holds the kernel against on the card.

The kernel reads every tensor through its strides (last dimension
contiguous), so the model passes its BSHD activations as transposed
views, and the output is allocated BSHD and returned as a BHSD view:
no transpose is copied on either side.  There is no fall back: a build
or launch failure raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_kernel_tensors

# kernel launches since the last reset; ``chip_smoke.py`` zeroes it
# before it drives the main path and reads it after.  A CUDA graph made
# by ``kernels.graphs.CountedGraph`` adds its launches at every replay.
launches = 0
COUNTERS = ("launches",)

NEG_INF = -2.0 ** 30     # repro.kernels.ref's mask value
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
TC_HEAD_DIMS = (64, 80, 96, 128, 256)   # the tensor-core body's head dims


def body(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int) -> str:
    """The kernel body a CUDA call at these types and head dim runs:
    "tensor_cores" for bf16 q, k and v at ``TC_HEAD_DIMS``, else
    "cuda_cores"."""
    if q_dtype == kv_dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,K,Skv,hd] -> [B,H,Sq,hd]: f32 scores,
    masked with -2**30, softmax, f32 weighted sum, cast to q's dtype —
    what ``repro.kernels.ref.flash_attention`` computes."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, K, G, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Skv, device=q.device)
    ok = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = s.masked_fill(~ok, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/flash_attention.cu``, built on first use, with its C
    signatures."""
    lib = build.load("flash_attention")
    for tq in _TYPES.values():
        for tkv in _TYPES.values():
            fn = getattr(lib, f"flash_attention_{tq}_{tkv}")
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_int64] * 12 + [ctypes.c_float]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel; raises unless q, k, v lie on one sm_90 card as
    f32 or bf16 with a contiguous last dimension, hd a multiple of 8 up
    to 256, H a multiple of K, and Skv >= 1; the tensor-core body (its
    tiles copied by TMA) further needs 16-byte aligned starts and
    strides that are multiples of 8 elements."""
    global launches
    check_kernel_tensors("flash attention", {"q": q, "k": k, "v": v},
                         dtypes=_TYPES, align=False)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention needs q [B,H,Sq,hd] and k/v "
                         f"[B,K,Skv,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not agree on batch, head_dim or heads (H % K)")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256], "
                         f"got {hd}")
    if Skv == 0:
        raise ValueError("flash attention needs at least one key")
    if body(q.dtype, k.dtype, hd) == "tensor_cores":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"the bf16 flash attention kernel copies "
                                 f"tiles by TMA: {name} must start 16-byte "
                                 f"aligned with strides that are multiples "
                                 f"of 8 elements, got strides {t.stride()}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0, got "
                         f"{window}, {q_offset}")
    # allocated BSHD (what the model consumes), returned as BHSD
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return out
    lib = _library()
    fn = getattr(lib, f"flash_attention_{_TYPES[q.dtype]}_"
                      f"{_TYPES[k.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, K, Sq, Skv, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(hd),
                 int(causal), int(window), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
