"""Softmax entropy / confidence statistics — the controller's L(x).

``entropy_stats(logits)`` -> (entropy [B] f32 in nats, max_prob [B]
f32, argmax [B] int32, the first index of the maximum), the port of
``repro.kernels.entropy.entropy_stats``:

  - on a CUDA tensor it launches the hand-written Hopper kernel
    ``csrc/entropy.cu`` and adds one to ``launches``; on a card that is
    not sm_90 it raises.  The kernel runs one of three schedules, chosen
    here by :func:`entropy_schedule` from (B, V, itemsize, SM count):
    packed rows (a thread per row), a warp per row, or a row split
    across blocks that merge in the same launch;
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
# before it drives the main path and reads it after.  A CUDA graph made
# by ``kernels.graphs.CountedGraph`` adds its launches at every replay.
launches = 0
COUNTERS = ("launches",)

_ENTRY = {torch.float32: "entropy_stats_f32",
          torch.bfloat16: "entropy_stats_bf16"}

# the schedules' constants; ``csrc/entropy.cu`` holds the same vector
# width and unroll (``kVecBytes``, ``kUnroll``)
PACKED_MAX_V = 16          # longest row one thread walks alone
WARP_MAX_ROW_BYTES = 4096  # longest row one warp reads (two rounds of loads)
SPLIT_THREADS = 256        # threads of a block of the split schedule
VEC_BYTES = 16             # one load of a lane: 4 f32 or 8 bf16
UNROLL = 4                 # vectors a lane keeps in flight
WAVES = 1                  # blocks of the split schedule per SM, at least
RESIDENT_THREADS = 2048    # threads an SM of sm_90 holds at once
_SCHEDULES = {"packed": 0, "warp": 1, "split": 2}


def entropy_schedule(B: int, V: int, itemsize: int, sms: int, *,
                     offset: int = 0) -> dict:
    """How the kernel runs a [B, V] tensor of ``itemsize``-byte logits
    starting ``offset`` bytes past a 16-byte boundary, on a card of
    ``sms`` SMs:

      - ``packed`` (V <= PACKED_MAX_V): a thread per row, up to 256 rows
        a block; each thread reads its row in loads of ``vector``
        elements, the widest (<= 16 bytes) that divides the row and
        every row's start;
      - ``warp`` (a row of at most WARP_MAX_ROW_BYTES): a warp per row,
        one warp a block, up to 8 once there are rows enough to give
        every SM two blocks;
      - ``split`` (longer rows): ``splits`` blocks of SPLIT_THREADS per
        row, so that B x splits reaches WAVES blocks per SM and, as far
        as the card holds the blocks at once, a block reads its slice in
        one round of UNROLL vectors a thread, each block one contiguous
        slice of the row; more than one slice merge in the same launch:
        the row's last block, found by an atomic ticket, merges the
        partials from global memory."""
    if B < 1 or V < 1:
        raise ValueError(f"entropy_schedule needs B, V >= 1, got {B}, {V}")
    if V <= PACKED_MAX_V:
        threads = min(256, -(-B // 32) * 32)
        vector = VEC_BYTES // itemsize
        while vector > 1 and (V % vector or offset % (vector * itemsize)):
            vector //= 2
        return {"schedule": "packed", "threads": threads,
                "blocks": -(-B // threads), "vector": vector, "splits": 1}
    if V * itemsize <= WARP_MAX_ROW_BYTES:
        rows = 1
        while rows < 8 and B >= 2 * rows * sms:
            rows *= 2
        return {"schedule": "warp", "threads": 32 * rows,
                "blocks": -(-B // rows), "vector": VEC_BYTES // itemsize,
                "splits": 1}
    vectors = V * itemsize // VEC_BYTES
    # enough blocks for WAVES a SM, and, as far as the card holds them at
    # once, slices of one round of loads; a vector for every thread
    resident = RESIDENT_THREADS // SPLIT_THREADS * sms
    splits = max(-(-WAVES * sms // B),
                 min(-(-vectors // (SPLIT_THREADS * UNROLL)), resident // B))
    splits = max(1, min(splits, vectors // SPLIT_THREADS))
    return {"schedule": "split", "threads": SPLIT_THREADS,
            "blocks": B * splits, "vector": VEC_BYTES // itemsize,
            "splits": splits}


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    lib.entropy_capture_id.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.entropy_capture_id.restype = ctypes.c_int
    lib.entropy_empty.argtypes = [ctypes.c_void_p]
    lib.entropy_empty.restype = ctypes.c_int
    lib.entropy_error_string.argtypes = [ctypes.c_int]
    lib.entropy_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (device, stream): one int32 ticket per row for the split
# schedule's merge, zero between calls (the row's last block puts it back
# to 0).  Calls on one stream are ordered, so they can share; an entry
# lives as long as the process (torch's pooled streams are never
# destroyed).  A stream destroyed while its work is pending, whose handle
# a new stream takes, would race with it on the tickets.
_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}
# per (device, stream) being captured into a CUDA graph: (the capture's
# id, its tickets)
_captured: dict[tuple[torch.device, int], tuple[int, torch.Tensor]] = {}


def _ticket_buffer(lib: ctypes.CDLL, device: torch.device, stream: int,
                   rows: int) -> torch.Tensor:
    """Zeroed tickets for ``rows`` rows on ``stream``.  Each CUDA graph
    capture gets its own, zeroed by a node of the graph before its first
    call in every replay: graphs captured on one stream (torch's one
    side stream of every ``torch.cuda.graph`` given none) may replay at
    once, and must not share tickets.  One graph replayed on two streams
    at once still races, as it does on all its other buffers."""
    if torch.cuda.is_current_stream_capturing():
        cid = ctypes.c_ulonglong(0)
        _raise_on(lib, lib.entropy_capture_id(stream, ctypes.byref(cid)))
        held = _captured.get((device, stream))
        if held is None or held[0] != cid.value or held[1].numel() < rows:
            held = (cid.value, torch.zeros(max(rows, 1024), dtype=torch.int32,
                                           device=device))
            _captured[(device, stream)] = held
        return held[1]
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"entropy kernel launch failed: "
                           f"{lib.entropy_error_string(err).decode()}")


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
    dev = logits.device
    ent = torch.empty(B, dtype=torch.float32, device=dev)
    maxp = torch.empty(B, dtype=torch.float32, device=dev)
    amax = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ent, maxp, amax
    plan = entropy_schedule(B, V, logits.element_size(),
                            _sm_count(dev.index or 0),
                            offset=logits.data_ptr() % VEC_BYTES)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials = tickets = None
        if plan["splits"] > 1:
            partials = torch.empty(B * plan["splits"], 4,
                                   dtype=torch.float32, device=dev)
            tickets = _ticket_buffer(lib, dev, stream, B)
        err = getattr(lib, _ENTRY[logits.dtype])(
            logits.data_ptr(), ent.data_ptr(), maxp.data_ptr(),
            amax.data_ptr(), B, V, _SCHEDULES[plan["schedule"]],
            plan["threads"], plan["vector"], plan["splits"],
            None if partials is None else partials.data_ptr(),
            None if tickets is None else tickets.data_ptr(), stream)
    _raise_on(lib, err)
    launches += 1
    return ent, maxp, amax


def empty_kernel_cuda(device: torch.device | int | str = "cuda") -> None:
    """Launch ``csrc/entropy.cu``'s empty kernel (one warp, no work) on
    the current stream: the card's launch floor, which bounds the
    kernel at the main path's shapes.  Not counted in ``launches``."""
    dev = torch.device(device)
    lib = _library()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.entropy_empty(
            torch.cuda.current_stream(dev).cuda_stream))


def entropy_stats(logits: torch.Tensor):
    """logits [B, V] -> (entropy, max_prob, argmax): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return entropy_stats_plain(logits)
    return entropy_stats_cuda(logits)
