"""Mamba-2 SSD chunked scan — the attention-free stacks' prefill hot spot.

``ssd_scan(x, dt, A, Bm, Cm)``: x [B,S,H,hd], dt [B,S,H], A [H] (< 0),
Bm/Cm [B,S,N] -> y [B,S,H,hd] in x's dtype from a zero initial state,
the port of ``repro.kernels.ssd_scan.ssd_scan``;
``ssd_chunked(x, dt, A, Bm, Cm, h0, chunk)`` -> (y, h_last
[B,H,hd,N] f32) from the state h0 [B,H,hd,N], the port of
``repro.models.ssd.ssd_chunked`` (a prefill into a decode cache):

  - on CUDA tensors each launches the hand-written Hopper kernels of
    ``csrc/ssd_scan.cu`` (two entry points, two schedules chosen by S,
    :func:`ssd_plan`: one launch over one chunk for S <= 64, the state
    copied asynchronously; three launches of the chunk-parallel SSD
    decomposition with 3xTF32 tensor-core products beyond; see the
    source for their bounds and design) and adds one to ``launches``
    per call; on a card that is not sm_90 it raises;
  - on CPU tensors ``ssd_scan`` runs ``ssd_scan_plain``, the per-token
    recurrence of ``repro.kernels.ref.ssd_scan``, and ``ssd_chunked``
    runs ``ssd_chunked_plain``, the chunked algorithm of
    ``repro.models.ssd.ssd_chunked``; ``chip_smoke.py`` holds the
    kernel against both on the card.

The arithmetic is f32 whatever the inputs' dtype (f32 or bf16); the
chunk-parallel products are 3xTF32, within f32's rounding.  The kernel
chooses its own chunk length (64, or 16 / 32 for a sequence that
short; the source says why), so the ``chunk`` of ``ssd_chunked`` is
the plain version's: the result is the same up to rounding.  There is
no fall back: a build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_kernel_tensors

# kernel launches (either entry point) since the last reset;
# ``chip_smoke.py`` zeroes it before it drives the main path and reads it
# after.  A CUDA graph made by ``kernels.graphs.CountedGraph`` adds its
# launches at every replay.
launches = 0
COUNTERS = ("launches",)

MAX_STATE = 128            # N the kernel takes (4 state columns a lane)
CHUNK = 64                 # the chunk-parallel chunk, the longest one chunk
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def ssd_plan(S: int) -> dict:
    """How the kernel runs a sequence of S rows: its schedule, the chunk
    length it takes and the kernels one call launches."""
    if S <= CHUNK:
        return {"schedule": "one_chunk",
                "chunk": 16 if S <= 16 else 32 if S <= 32 else CHUNK,
                "kernels": 1}
    return {"schedule": "chunk_parallel", "chunk": CHUNK, "kernels": 3}


def ssd_scan_plain(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The per-token recurrence from a zero state, in f32, y cast to x's
    dtype — what ``repro.kernels.ref.ssd_scan`` computes."""
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(B, H, hd, N, dtype=torch.float32, device=x.device)
    A = A.float()
    y = torch.empty(B, S, H, hd, dtype=torch.float32, device=x.device)
    for t in range(S):
        dtt = dt[:, t].float()
        a = torch.exp(A[None] * dtt)                              # [B,H]
        h = (a[:, :, None, None] * h
             + torch.einsum("bh,bhd,bn->bhdn", dtt, x[:, t].float(),
                            Bm[:, t].float()))
        y[:, t] = torch.einsum("bn,bhdn->bhd", Cm[:, t].float(), h)
    return y.to(x.dtype)


def ssd_chunked_plain(x, dt, A, Bm, Cm, h0, chunk: int):
    """The chunked SSD algorithm of ``repro.models.ssd.ssd_chunked``, in
    f32: the quadratic form within chunks of ``min(chunk, S)`` rows
    (padded rows take dt = 0, the identity for the state), chunk states
    carried across by a loop.  -> (y [B,S,H,hd] in x's dtype, h_last
    [B,H,hd,N] f32).  Differentiable, and the path a train step takes:
    the intra-chunk decay is masked before its exponential, so the
    gradient is finite where the forward is."""
    B_, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(B_, nc, Q, H, hd)
    dtc = dtf.reshape(B_, nc, Q, H)
    Bc = Bf.reshape(B_, nc, Q, N)
    Cc = Cf.reshape(B_, nc, Q, N)

    l = torch.cumsum(A.float() * dtc, dim=2)              # [B,nc,Q,H] <= 0
    # intra-chunk: att[b,c,h,t,s] = exp(l_t - l_s) (C_t . B_s) dt_s, s <= t
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    decay = (l[:, :, :, None, :] - l[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # the reference exponentiates the whole block and masks after: for
    # s > t, l_t - l_s > 0 overflows f32 past 88 (mamba2's chunk of 256
    # reaches thousands), and the masked inf sends 0 * inf = NaN into the
    # gradient; masking before the exponential keeps the forward's values
    # and gives a finite gradient
    att = torch.where(mask, torch.exp(torch.where(mask, decay, -torch.inf))
                      * cb[:, :, None], 0.0)
    att = att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchts,bcshd->bcthd", att, xc)
    # chunk states: sum_s exp(l_last - l_s) dt_s x_s (x) B_s
    w = torch.exp(l[:, :, -1:, :] - l) * dtc              # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhd->bchdn", Bc, xc * w[..., None])
    # inter-chunk recurrence, each chunk reading the state before it
    chunk_decay = torch.exp(l[:, :, -1, :])               # [B,nc,H]
    h = h0.float()
    prevs = []
    for c in range(nc):
        prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prevs = torch.stack(prevs, 1)                        # [B,nc,H,hd,N]
    y_inter = (torch.einsum("bcqn,bchdn->bcqhd", Cc, h_prevs)
               * torch.exp(l)[..., None])
    y = (y_intra + y_inter).reshape(B_, nc * Q, H, hd)
    return y[:, :S].to(x.dtype), h


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/ssd_scan.cu``, built on first use, with its C signatures."""
    lib = build.load("ssd_scan")
    for entry in ("ssd_scan", "ssd_chunked"):
        for t in _TYPES.values():
            fn = getattr(lib, f"{entry}_{t}")
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_int64] * 10 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.ssd_scan_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_workspace_floats.restype = ctypes.c_int64
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    if lib.ssd_scan_chunk() != CHUNK:
        raise RuntimeError(f"csrc/ssd_scan.cu takes chunks of "
                           f"{lib.ssd_scan_chunk()} rows, ssd_scan.py "
                           f"plans {CHUNK}")
    return lib


def _launch(entry: str, x, dt, A, Bm, Cm, h0=None):
    """Check the inputs, launch ``entry`` (``ssd_scan`` or
    ``ssd_chunked``), count it; -> (y, h_last or None)."""
    global launches
    check_kernel_tensors("SSD scan", {"x": x, "Bm": Bm, "Cm": Cm},
                         dtypes=_TYPES, align=True)
    check_kernel_tensors("SSD scan", {"dt": dt, "A": A}, dtypes=_TYPES,
                         align=False, device=x.device)
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"the SSD scan needs x [B,S,H,hd], dt [B,S,H], "
                         f"A [H] and Bm/Cm [B,S,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} do not agree")
    if dt.dtype != x.dtype or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, dt, Bm and Cm must share one dtype, got "
                        f"{x.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if hd % 4 or N % 4 or not 0 < N <= MAX_STATE:
        raise ValueError(f"the SSD scan needs hd and N multiples of 4 and "
                         f"N <= {MAX_STATE}, got hd {hd}, N {N}")
    y = torch.empty(B, S, H, hd, dtype=x.dtype, device=x.device)
    h_last = None
    if h0 is not None:
        check_kernel_tensors("SSD scan", {"h0": h0}, dtypes={torch.float32},
                             align=False, device=x.device)
        if tuple(h0.shape) != (B, H, hd, N) or not h0.is_contiguous():
            raise ValueError(f"h0 must be a contiguous [B,H,hd,N] = "
                             f"{(B, H, hd, N)} f32 tensor, got "
                             f"{tuple(h0.shape)}, strides {h0.stride()}")
        h_last = torch.empty_like(h0)
        if S == 0:
            h_last.copy_(h0)
    if B == 0 or S == 0 or H == 0:
        return y, h_last
    A = A.float().contiguous()
    lib = _library()
    fn = getattr(lib, f"{entry}_{_TYPES[x.dtype]}")
    # the chunk-parallel schedule's chunk states, C.B^T and decays
    work = torch.empty(lib.ssd_scan_workspace_floats(B, S, H, hd, N),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                 0 if h_last is None else h_last.data_ptr(), y.data_ptr(),
                 work.data_ptr() if work.numel() else 0,
                 B, S, H, hd, N, *x.stride()[:3], *dt.stride(),
                 *Bm.stride()[:2], *Cm.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    launches += 1
    return y, h_last


def ssd_scan_cuda(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The CUDA kernel from a zero state; raises unless every tensor lies
    on one sm_90 card, x, dt, Bm and Cm share f32 or bf16, x, Bm and Cm
    have 16-byte aligned rows, hd and N are multiples of 4 and
    N <= 128."""
    return _launch("ssd_scan", x, dt, A, Bm, Cm)[0]


def ssd_chunked_cuda(x, dt, A, Bm, Cm, h0):
    """The CUDA kernel from the state ``h0`` (contiguous f32
    [B,H,hd,N]); -> (y, h_last).  Raises as ``ssd_scan_cuda``."""
    return _launch("ssd_chunked", x, dt, A, Bm, Cm, h0)


def ssd_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the per-token plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm)
    return ssd_scan_cuda(x, dt, A, Bm, Cm)


def ssd_chunked(x, dt, A, Bm, Cm, h0, chunk: int):
    """The CUDA kernel for CUDA tensors, the chunked plain version (at
    ``chunk``) for CPU tensors; -> (y, h_last)."""
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, Bm, Cm, h0, chunk)
    return ssd_chunked_cuda(x, dt, A, Bm, Cm, h0)
