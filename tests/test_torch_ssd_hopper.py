"""The Hopper design of the SSD scan kernel, held on the CPU.

The CUDA kernel (``csrc/ssd_scan.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain versions.  Here its two
schedules are emulated in plain PyTorch, in the kernel's order, on inputs
made from numpy seeds:

  - the plan the wrapper launches by (:func:`ssd_scan.ssd_plan`): one
    chunk of 16, 32 or 64 rows in one launch up to S = 64, three launches
    over chunks of 64 beyond, the chunk equal to the source's ``kQ``;
  - one chunk: the chunked algorithm over a single chunk in f32;
  - chunk-parallel (the SSD decomposition of the Mamba-2 paper, sec. 6):
    C.B^T once per (b, chunk), every chunk's own state from zero, the
    sequential pass over the [hd, N] states alone, then the outputs; each
    product in 3xTF32 (each operand split into its f32 bits with the low
    13 mantissa bits masked and the masked residual; hi.hi + hi.lo +
    lo.hi), as the tensor cores run it;

against ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) and
``repro.kernels.ref.ssd_scan`` from a zero state, and
``repro.models.ssd.ssd_chunked`` from a random one, at S over one, two
and a ragged number of chunks, within ``tests/test_torch_ssd.py``'s
tolerances (2e-4 for the scan, 1e-4 with a state).  At mamba2's widths
(hd 64, N 128) the card's check (``chip_smoke.py``: the largest error
within ``F32_TOL`` = 1e-4 of the plain output's largest magnitude) is
shown to hold for the emulated 3xTF32 arithmetic and to fail a dropped
chunk state, a missing chunk decay and a single-TF32 product.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssdk  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

SCAN_TOL = 2e-4         # tests/test_torch_ssd.py
STATE_TOL = 1e-4        # tests/test_torch_ssd.py
F32_TOL = 1e-4          # chip_smoke.py: relative to the largest |y|
FAULTS = ("drop_state", "no_decay", "single_tf32")


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t's f32 bits with the low 13 mantissa bits masked: what a TF32
    operand of the tensor cores keeps."""
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b as the kernel computes it: plain ("f32", "f64"), 3xTF32 (the
    small products first) or single TF32 (a planted fault)."""
    if mode in ("f32", "f64"):
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if mode == "single_tf32":
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulate(x, dt, A, Bm, Cm, h0, *, fault=None, f64=False):
    """The kernel's schedule for these shapes (``ssd_plan``): one chunk of
    Q rows in f32, or the chunk-parallel decomposition over chunks of
    ``CHUNK`` rows in 3xTF32; ``fault`` plants one of ``FAULTS``; ``f64``
    runs the same schedule in float64 with plain products (the
    reference for the arithmetic).  -> (y [B,S,H,hd], h_last)."""
    plan = tssd.ssd_plan(x.shape[1])
    dtype = torch.float64 if f64 else torch.float32
    mode = ("f64" if f64 else "f32" if plan["schedule"] == "one_chunk"
            else "single_tf32" if fault == "single_tf32" else "3xtf32")
    x, dt, A, Bm, Cm, h0 = (t.to(dtype) for t in (x, dt, A, Bm, Cm, h0))
    B_, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = plan["chunk"]
    nc = -(-S // Q)
    pad = nc * Q - S
    # rows past S: zeros with dt = 0, the identity for the state
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    xc = x.reshape(B_, nc, Q, H, hd)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, N)
    Cc = Cm.reshape(B_, nc, Q, N)
    l = torch.cumsum(A * dtc, dim=2)                          # [B,nc,Q,H]
    # C.B^T once per (b, chunk): the state kernel's extra row of blocks
    cb = _mm(Cc, Bc.transpose(-1, -2), mode)                  # [B,nc,Q,Q]
    # chunk_state_kernel: each chunk's own state from zero, and its decay
    w = torch.exp(l[:, :, -1:] - l) * dtc                     # [B,nc,Q,H]
    xw = (xc * w[..., None]).permute(0, 1, 3, 4, 2)           # [B,nc,H,hd,Q]
    states = _mm(xw, Bc[:, :, None], mode)                    # [B,nc,H,hd,N]
    decay = torch.exp(l[:, :, -1])                            # [B,nc,H]
    if fault == "no_decay":
        decay = torch.ones_like(decay)
    # state_pass_kernel: the states before each chunk, and the last
    h = h0
    prevs = []
    for c in range(nc):
        prevs.append(h)
        s_c = states[:, c]
        if fault == "drop_state" and c == nc // 2:
            s_c = torch.zeros_like(s_c)
        h = decay[:, c, :, None, None] * h + s_c
    hp = torch.stack(prevs, 1)                                # [B,nc,H,hd,N]
    # chunk_scan_kernel: y = att . x + diag(exp(l)) C . h_prev^T
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]          # [B,nc,t,s,H]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()[..., None]
    att = torch.where(tri, torch.exp(diff) * cb[..., None]
                      * dtc[:, :, None, :, :], 0.0).permute(0, 1, 4, 2, 3)
    y = _mm(att, xc.permute(0, 1, 3, 2, 4), mode)             # [B,nc,H,t,hd]
    ce = Cc[:, :, None] * torch.exp(l).permute(0, 1, 3, 2)[..., None]
    y = y + _mm(ce, hp.transpose(-1, -2), mode)
    y = y.permute(0, 1, 3, 2, 4).reshape(B_, nc * Q, H, hd)[:, :S]
    return y, h


def _inputs(B, S, H, hd, N, seed):
    """x, dt (softplus'd), A (< 0), Bm, Cm and a nonzero h0, f32, as
    ``tests/test_torch_ssd.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, hd, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _mamba2_inputs(S, H, seed):
    """The card's inputs (``chip_smoke._ssd_inputs``) at mamba2's widths
    (hd 64, N 128) with H heads: normal x, B, C, softplus'd normal dt,
    the decay rates -(1..16), a random h0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, S, H, 64)).astype(np.float32)
    Bm = rng.standard_normal((1, S, 128)).astype(np.float32)
    Cm = rng.standard_normal((1, S, 128)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, S, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = rng.standard_normal((1, H, 64, 128)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The card's measure: the largest error over the largest |want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,schedule,chunk,kernels", [
    (1, "one_chunk", 16, 1),
    (16, "one_chunk", 16, 1),
    (17, "one_chunk", 32, 1),
    (33, "one_chunk", 64, 1),
    (64, "one_chunk", 64, 1),
    (65, "chunk_parallel", 64, 3),
    (300, "chunk_parallel", 64, 3),
    (4096, "chunk_parallel", 64, 3),
])
def test_ssd_plan(S, schedule, chunk, kernels):
    assert tssd.ssd_plan(S) == {"schedule": schedule, "chunk": chunk,
                                "kernels": kernels}


def test_chunk_matches_the_cuda_source():
    src = (build.CSRC / "ssd_scan.cu").read_text()
    assert int(re.search(r"constexpr int kQ = (\d+);", src).group(1)) \
        == tssd.CHUNK


# ---------------------------------------------------------------------------
# the emulation against the reference
# ---------------------------------------------------------------------------

# S over one chunk (16, 64), two (65, 128) and a ragged number (200 =
# 3 x 64 + 8)
SHAPES = [
    (2, 16, 3, 8, 16),
    (1, 64, 2, 16, 8),
    (1, 65, 3, 8, 8),
    (2, 128, 2, 8, 16),
    (1, 200, 2, 16, 8),
]


@pytest.mark.parametrize("B,S,H,hd,N", SHAPES)
def test_emulation_from_zero_matches_pallas_and_ref(B, S, H, hd, N):
    x, dt, A, Bm, Cm, h0 = _inputs(B, S, H, hd, N, seed=S + H)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    y_ref = jref.ssd_scan(*j)
    y_pallas = jssdk.ssd_scan(*j, chunk=64, interpret=True)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, _ = _emulate(*t, torch.zeros(B, H, hd, N))
    assert y.shape == (B, S, H, hd) and y.dtype == torch.float32
    _close(y, y_ref, SCAN_TOL)
    _close(y, y_pallas, SCAN_TOL)


@pytest.mark.parametrize("B,S,H,hd,N", SHAPES)
def test_emulation_with_state_matches_ssd_chunked(B, S, H, hd, N):
    arrays = _inputs(B, S, H, hd, N, seed=2 * S + H)
    y_j, h_j = jssd.ssd_chunked(*[jnp.asarray(a) for a in arrays], 256)
    y, h = _emulate(*[torch.from_numpy(a) for a in arrays])
    _close(y, y_j, STATE_TOL)
    _close(h, h_j, STATE_TOL)


# ---------------------------------------------------------------------------
# the card's check at mamba2's widths
# ---------------------------------------------------------------------------

def test_emulated_3xtf32_error_at_mamba2_widths():
    """3xTF32 against the same schedule in float64: a tenth of
    ``F32_TOL`` at most; against the f32 plain version the card compares
    with (whose own error, printed beside, is the larger part): within
    ``F32_TOL``."""
    args = _mamba2_inputs(1000, 4, seed=0)
    y, h = _emulate(*args)
    y64, h64 = _emulate(*args, f64=True)
    y_plain, h_plain = tssd.ssd_chunked_plain(*args, 256)
    errs = {"y_vs_f64": _scaled_err(y, y64),
            "h_vs_f64": _scaled_err(h, h64),
            "y_vs_plain": _scaled_err(y, y_plain),
            "h_vs_plain": _scaled_err(h, h_plain),
            "plain_y_vs_f64": _scaled_err(y_plain, y64)}
    print("emulated 3xTF32 at hd 64, N 128, S 1000:", errs)
    assert max(errs["y_vs_f64"], errs["h_vs_f64"]) <= F32_TOL / 10
    assert max(errs["y_vs_plain"], errs["h_vs_plain"]) <= F32_TOL


@pytest.mark.parametrize("fault", FAULTS)
def test_f32_tol_fails_a_planted_fault(fault):
    """Each fault moves y beyond the card's limit, relative to the plain
    version's largest output (5 chunks, a random h0)."""
    args = _mamba2_inputs(300, 4, seed=1)
    want, _ = tssd.ssd_chunked_plain(*args, 256)
    good, _ = _emulate(*args)
    bad, _ = _emulate(*args, fault=fault)
    print(f"{fault}: {_scaled_err(bad, want)} (unfaulted "
          f"{_scaled_err(good, want)})")
    assert _scaled_err(good, want) <= F32_TOL
    assert _scaled_err(bad, want) > F32_TOL
