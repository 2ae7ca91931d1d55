"""Flash-decode — one new token per slot against a contiguous KV cache.

``decode_attention(q, k, v, kv_pos, cur_pos, window=)``: q [B,H,hd];
k/v [B,K,S,hd]; kv_pos [B,S] int32 (absolute position of each cache
row, -1 = empty); cur_pos [B] int32 -> [B,H,hd] in q's dtype, the port
of ``repro.kernels.decode_attention.decode_attention``:

  - on CUDA tensors it launches the hand-written Hopper kernel
    ``csrc/decode_attention.cu`` (one block per slot, kv head and group
    of up to four query heads; the valid rows streamed once; see the
    source for its bound and design) and adds one to ``launches``; on a
    card that is not sm_90 it raises;
  - on CPU tensors it runs ``decode_attention_plain``, the plain
    PyTorch version of ``repro.kernels.ref.decode_attention``, which
    ``chip_smoke.py`` also holds the kernel against on the card.

q and k/v may differ in dtype (f32 or bf16 each: the model's f32
params meet its default bf16 cache); the math is f32.  Every tensor is
read through its strides, so the model's BSHD cache [B,C,K,hd] goes in
as a transposed view, read in place.  A slot with no valid row gives
0 here, the mean of its rows in the TPU kernel and of all rows in the
plain version: nothing reads such a row's output, and comparisons skip
it.  The contiguous entry point only: the paged pool and its gather
shim come with the paged-KV slice.  There is no fall back: a build or
launch failure raises.
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


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/decode_attention.cu``, built on first use, with its C
    signatures."""
    lib = build.load("decode_attention")
    for tq in _TYPES.values():
        for tkv in _TYPES.values():
            fn = getattr(lib, f"decode_attention_{tq}_{tkv}")
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_int64] * 12 + [ctypes.c_float,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_cuda(q, k, v, kv_pos, cur_pos, *,
                          window: int = 0) -> torch.Tensor:
    """The CUDA kernel; raises unless every tensor lies on one sm_90
    card, q and k/v are f32 or bf16 with 16-byte aligned rows, kv_pos
    and cur_pos are int32, hd is a multiple of 8 up to 256 and H a
    multiple of K."""
    global launches
    check_kernel_tensors("decode attention", {"q": q, "k": k, "v": v},
                         dtypes=_TYPES, align=True)
    check_kernel_tensors("decode attention",
                         {"kv_pos": kv_pos, "cur_pos": cur_pos},
                         dtypes={torch.int32}, align=False, device=q.device)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention needs q [B,H,hd] and k/v "
                         f"[B,K,S,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not agree on batch, head_dim or heads (H % K)")
    if tuple(kv_pos.shape) != (B, S) or tuple(cur_pos.shape) != (B,):
        raise ValueError(f"kv_pos must be [B,S] = {(B, S)} and cur_pos "
                         f"[B], got {tuple(kv_pos.shape)}, "
                         f"{tuple(cur_pos.shape)}")
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
    fn = getattr(lib, f"decode_attention_{_TYPES[q.dtype]}_"
                      f"{_TYPES[k.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
                 B, H, K, S, hd, *q.stride()[:2], *k.stride()[:3],
                 *v.stride()[:3], *kv_pos.stride(), *out.stride()[:2],
                 1.0 / math.sqrt(hd), int(window), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(err).decode()}")
    launches += 1
    return out


def decode_attention(q, k, v, kv_pos, cur_pos, *,
                     window: int = 0) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_pos, cur_pos,
                                      window=window)
    return decode_attention_cuda(q, k, v, kv_pos, cur_pos, window=window)
