"""Softmax entropy / confidence statistics — the controller's L(x).

``entropy_stats(logits)`` -> (entropy [B] f32 in nats, max_prob [B]
f32, argmax [B] int32, the first index of the maximum), the port of
``repro.kernels.entropy.entropy_stats``:

  - on a CUDA tensor it launches the hand-written Hopper kernel
    ``csrc/entropy.cu`` (one block per row, an online (max, sum-exp,
    sum-x·exp, argmax) in one pass over V) and adds one to
    ``launches``; on a card that is not sm_90 it raises;
  - on a CPU tensor it runs ``entropy_stats_plain``, the plain PyTorch
    version of ``repro.kernels.ref.entropy_stats``, which
    ``chip_smoke.py`` also holds the kernel against on the card.

There is no fall back: a build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import is_hopper

# kernel launches since the last reset; ``chip_smoke.py`` zeroes it
# before it drives the main path and reads it after
launches = 0

_ENTRY = {torch.float32: "entropy_stats_f32",
          torch.bfloat16: "entropy_stats_bf16"}


def entropy_stats_plain(logits: torch.Tensor):
    """logits [B, V] -> (entropy [B], max_prob [B], argmax [B] int32)
    in plain PyTorch: softmax, log-softmax, ``-Σ p·log p``, ``max p``
    and the first-index argmax, all in f32."""
    x = logits.float()
    p = torch.softmax(x, dim=-1)
    logp = torch.log_softmax(x, dim=-1)
    ent = -(p * logp).sum(dim=-1)
    return ent, p.amax(dim=-1), x.argmax(dim=-1).to(torch.int32)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/entropy.cu``, built on first use, with its C signatures."""
    lib = build.load("entropy")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.entropy_error_string.argtypes = [ctypes.c_int]
    lib.entropy_error_string.restype = ctypes.c_char_p
    return lib


def entropy_stats_cuda(logits: torch.Tensor):
    """The CUDA kernel; raises unless ``logits`` is a contiguous 2-D f32
    or bf16 tensor on an sm_90 card."""
    global launches
    if logits.device.type != "cuda":
        raise ValueError(f"the CUDA entropy kernel needs a CUDA tensor, got "
                         f"one on {logits.device}")
    if not is_hopper(logits.device):
        raise RuntimeError(
            f"the entropy kernel is built for sm_90a; "
            f"{torch.cuda.get_device_name(logits.device)} has capability "
            f"{torch.cuda.get_device_capability(logits.device)}")
    if logits.dtype not in _ENTRY:
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"logits must be [B, V] with V >= 1, got "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    B, V = logits.shape
    ent = torch.empty(B, dtype=torch.float32, device=logits.device)
    maxp = torch.empty(B, dtype=torch.float32, device=logits.device)
    amax = torch.empty(B, dtype=torch.int32, device=logits.device)
    if B == 0:
        return ent, maxp, amax
    lib = _library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = getattr(lib, _ENTRY[logits.dtype])(
            logits.data_ptr(), ent.data_ptr(), maxp.data_ptr(),
            amax.data_ptr(), B, V, stream)
    if err != 0:
        raise RuntimeError(f"entropy kernel launch failed: "
                           f"{lib.entropy_error_string(err).decode()}")
    launches += 1
    return ent, maxp, amax


def entropy_stats(logits: torch.Tensor):
    """logits [B, V] -> (entropy, max_prob, argmax): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return entropy_stats_plain(logits)
    return entropy_stats_cuda(logits)
