"""Causal GQA flash attention — the prefill hot spot.

``flash_attention(q, k, v, causal=, window=, q_offset=)``: q [B,H,Sq,hd],
k/v [B,K,Skv,hd] (GQA: H = K*G) -> [B,H,Sq,hd] in q's dtype, the port of
``repro.kernels.flash_attention.flash_attention``:

  - on CUDA tensors it launches the hand-written Hopper kernel
    ``csrc/flash_attention.cu`` (one block per 32-row query tile and
    head, K/V tiles of 32 keys staged in shared memory, an online f32
    softmax in registers; see the source for its bound and design) and
    adds one to ``launches``; on a card that is not sm_90 it raises;
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
# before it drives the main path and reads it after
launches = 0

NEG_INF = -2.0 ** 30     # repro.kernels.ref's mask value
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
    to 256, H a multiple of K, and Skv >= 1."""
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
