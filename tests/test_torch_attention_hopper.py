"""The Hopper designs of the two attention kernels, held on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions, the paged kernel against its gather shim
and a one-span cache against a many-span one, byte for byte).  Here
their arithmetic is emulated in plain PyTorch, in the kernels' order,
on inputs made from numpy seeds, and held against the JAX oracles
(``repro.kernels.ref``):

  - the split-span flash-decode (``csrc/decode_attention.cu``): the span
    plan the wrapper launches by (1024 rows at hd <= 128, 128 above) and
    the body it runs by G and hd; each span's warps, tiles and subgroups
    merged as the narrow body (G = 1) merges them, each warp's 8-row
    tiles worked as the GQA body (G > 1 at hd <= 128, every head of a kv
    head in one block) works them, or the 32-row tiles of the wide body
    (hd 256); f32 to 1e-5 against ``ref.decode_attention``, and bitwise
    equal with and without trailing empty spans and between the
    contiguous and the paged layout (bs 1, 16, 128), at granite's,
    llama3's and the smoke configurations' G and at hd 256 too, which is
    what lets the card's native == shim, paged == contiguous and
    one-span == many-span checks hold;
  - the tensor-core flash prefill (``csrc/flash_attention.cu``): 64-row
    query tiles, 64-key tiles, scores in f32, P rounded to bf16 before
    P.V, the sum of the weights in f32; against
    ``ref.flash_attention`` at hd 64, 80, 128 and 256 (G = 10 and 8
    over one kv head), causal, windowed and ragged, within the error
    budget ``_within_budget`` states and the card's row limit; which
    body a call runs (tensor cores at hd 64, 80, 96, 128, 256 in bf16,
    the CUDA cores otherwise);
  - the card's bf16 limit (``row_scaled_error`` within
    ``ATTN_BF16_ROW_TOL``): it covers the tensor-core arithmetic at the
    card's long shapes, and a dropped key tile, a dropped span or a
    span merged without its rescale breaks it;
  - the build: the library hash follows the local headers a source
    includes, and every kernel builds from the repository and the CUDA
    toolkit alone, with the same flags.
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.runtime import (ATTN_BF16_ROW_TOL,  # noqa: E402
                                         row_scaled_error)

NEG = -1e30            # the kernels' mask value and initial running max
WARPS = 8
L = tda.SPAN


# ---------------------------------------------------------------------------
# the split-span flash-decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [80, 128, 256])
@pytest.mark.parametrize("S", [1, 128, L, L + 1, 8192])
def test_decode_span_plan(S, hd):
    # stablelm's 32 heads; at hd 256 recurrentgemma's G = 10 and
    # paligemma's G = 8 over one kv head: the span follows hd alone
    B = 8
    span = tda.span_rows(hd)
    assert span == (L if hd <= 128 else tda.SPAN_WIDE)
    for H in ((32,) if hd <= 128 else (10, 8)):
        plan = tda.decode_span_plan(B, H, S, hd)
        spans = -(-S // span)
        assert plan.spans == spans
        if S <= span:
            # the serving shape: one launch, the kernel writes out itself
            assert plan.scratch_shape is None and plan.combine is False
        else:
            assert plan.scratch_shape == (B, H, spans, hd + 2)
            assert plan.combine is True
    # recurrentgemma's 2048-row ring: 16 spans, 128 blocks at 8 slots
    assert tda.decode_span_plan(8, 10, 2048, 256).spans == 16


def test_span_length_matches_the_cuda_source():
    src = (build.CSRC / "decode_attention.cu").read_text()
    assert int(re.search(r"kSpan = (\d+);", src).group(1)) == tda.SPAN
    assert int(re.search(r"kSpanWide = (\d+);", src).group(1)) == (
        tda.SPAN_WIDE)
    assert int(re.search(r"kTileWide = (\d+);", src).group(1)) == TILE_WIDE
    assert int(re.search(r"kHeadsWide = (\d+);", src).group(1)) == (
        HEADS_WIDE)
    assert "return hd <= 128 ? kSpan : kSpanWide;" in src
    assert [tda.span_rows(hd) for hd in (64, 128, 136, 256)] == [
        L, L, tda.SPAN_WIDE, tda.SPAN_WIDE]


@pytest.mark.parametrize("H,K,hd,body", [
    (32, 32, 80, "narrow"), (16, 16, 64, "narrow"), (4, 4, 128, "narrow"),
    (24, 8, 64, "gqa"), (48, 8, 128, "gqa"), (128, 8, 128, "gqa"),
    (8, 4, 32, "gqa"), (16, 4, 16, "gqa"), (8, 4, 80, "gqa"),
    (10, 1, 256, "wide"), (8, 1, 256, "wide"), (4, 4, 136, "wide")])
def test_decode_body_matches_the_cuda_source(H, K, hd, body):
    """The Python mirror of ``launch()``'s choice (``decode_body``)
    against the CUDA source: the wide body above hd 128, the narrow body
    at G = 1, the GQA body at G > 1, in instances of 4, 8 or 16 query
    heads (groups of 16 above) and 64 or 128 head dims."""
    src = (build.CSRC / "decode_attention.cu").read_text()
    launch = src[src.index("int launch(const DecodeArgs& a"):]
    launch = launch[:launch.index("\n}\n")]
    assert "if (a.hd > 128) return launch_wide<" in launch
    assert "if (a.H == a.K) return launch_body<" in launch
    assert "if (a.hd <= 64) return launch_gqa<TQ, TKV, kPaged, 64>" in launch
    assert "return launch_gqa<TQ, TKV, kPaged, 128>" in launch
    pick = src[src.index("int launch_gqa(const DecodeArgs& a"):]
    pick = pick[:pick.index("\n}\n")]
    buckets = [(int(m.group(1)), int(m.group(2))) for m in re.finditer(
        r"if \(G <= (\d+)\) return launch_gqa_instance<TQ, TKV, kPaged, "
        r"(\d+), HD>", pick)]
    assert buckets == [(4, 4), (8, 8)]
    assert "return launch_gqa_instance<TQ, TKV, kPaged, 16, HD>" in pick
    assert tda.decode_body(H, K, hd) == body
    assert int(re.search(r"kTileGqa = (\d+);", src).group(1)) == TILE_GQA


TILE_WIDE = 32         # the wide body's rows per tile (kTileWide)
HEADS_WIDE = 16        # and its query heads per block (kHeadsWide)
TILE_GQA = 8           # the GQA body's rows of a warp's tile (kTileGqa)
HEADS_GQA = 16         # and its query heads per block, at most


def _narrow_span(qg, read, b, kh, ok_row, s_begin, s_end, rj=2):
    """One span of the narrow body (G = 1 at hd <= 128) for the heads qg
    [G, hd]: each warp's tiles of 4 x rj rows (two rows a lane), its four
    subgroups' partial accumulators, then the warps merged in order ->
    (max [G], sum [G], acc [G, hd])."""
    G, hd = qg.shape
    S = len(ok_row)
    wm, wl, wacc = [], [], []
    for w in range(WARPS):
        m = torch.full((G,), NEG)
        l = torch.zeros(G)
        acc = torch.zeros(4, G, hd)                  # subgroups
        for base in range(s_begin, s_end, 32 * rj):
            rows = torch.tensor([[base + 32 * j + 4 * w + r
                                  for r in range(4)]
                                 for j in range(rj)])
            ok = rows < s_end
            ok &= ok_row[rows.clamp(max=S - 1)]
            if not ok.any():
                continue
            kr, vr = read(b, kh, rows[ok])
            k = torch.zeros(rj, 4, hd)
            v = torch.zeros(rj, 4, hd)
            k[ok], v[ok] = kr.float(), vr.float()
            s = torch.einsum("gd,jrd->gjr", qg, k)
            s = torch.where(ok, s, torch.tensor(NEG))
            m_new = torch.maximum(m, s.amax(dim=(1, 2)))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None, None])   # [G,rj,4]
            ps = torch.zeros(G, 4)
            for j in range(rj):
                ps = ps + p[:, j]
            psum = (ps[:, 0] + ps[:, 1]) + (ps[:, 2] + ps[:, 3])
            l = l * corr + psum
            for r in range(4):
                a = acc[r] * corr[:, None]
                for j in range(rj):
                    a = a + p[:, j, r, None] * v[j, r]
                acc[r] = a
            m = m_new
        wm.append(m)
        wl.append(l)
        wacc.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
    return _merge_warps(wm, wl, wacc)


def _merge_warps(wm, wl, wacc):
    """The 8 warps' (max, sum, acc) merged in warp order, as the narrow
    and the GQA bodies merge them through shared memory."""
    mx = torch.full_like(wm[0], NEG)
    for w in range(WARPS):
        mx = torch.maximum(mx, wm[w])
    tot, num = torch.zeros_like(wl[0]), torch.zeros_like(wacc[0])
    for w in range(WARPS):
        c = torch.exp(wm[w] - mx)
        tot = tot + wl[w] * c
        num = num + wacc[w] * c[:, None]
    return mx, tot, num


def _gqa_span(qg, read, b, kh, ok_row, s_begin, s_end):
    """One span of the GQA body (G > 1, hd <= 128) for the heads qg
    [G, hd]: warp w's tiles of 8 rows (of every 64, rows 4w .. 4w + 3 and
    32 + 4w .. + 3, in that order), each scored against every head, one
    max and one rescale per head and tile, the weights' sum by the
    warp's butterfly over the 8 rows (xor 1, 2, 4), the accumulators
    adding the valid rows in row order; then the warps merged in order
    -> (max [G], sum [G], acc [G, hd])."""
    G, hd = qg.shape
    S = len(ok_row)
    wm, wl, wacc = [], [], []
    for w in range(WARPS):
        m = torch.full((G,), NEG)
        l = torch.zeros(G)
        acc = torch.zeros(G, hd)
        for base in range(s_begin, s_end, TILE_GQA * WARPS):
            rows = base + 4 * w + _GQA_ROWS
            ok = (rows < s_end) & ok_row[rows.clamp(max=S - 1)]
            if not ok.any():
                continue
            kr, vr = read(b, kh, rows[ok])
            k = torch.zeros(TILE_GQA, hd)
            v = torch.zeros(TILE_GQA, hd)
            k[ok], v[ok] = kr.float(), vr.float()
            s = torch.where(ok, qg @ k.T, torch.tensor(NEG))      # [G, 8]
            m_new = torch.maximum(m, s.amax(1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            ps = p
            for o in (1, 2, 4):
                ps = ps + ps[:, _GQA_RHO ^ o]
            l = l * corr + ps[:, 0]
            acc = acc * corr[:, None]
            for t in torch.nonzero(ok).flatten().tolist():
                acc = acc + p[:, t, None] * v[t]
            m = m_new
        wm.append(m)
        wl.append(l)
        wacc.append(acc)
    return _merge_warps(wm, wl, wacc)


# a warp's tile row rho = 4j + r is row 32j + 4w + r of its 64-row group
_GQA_RHO = torch.arange(TILE_GQA)
_GQA_ROWS = 32 * (_GQA_RHO // 4) + _GQA_RHO % 4
_LANES = torch.arange(TILE_WIDE)


def _wide_span(qg, read, b, kh, ok_row, s_begin, s_end):
    """One span of the wide body (hd > 128) for the heads qg [G, hd]:
    tiles of 32 rows, each scored against every head, one max and one
    rescale per head and tile, the weights' sum by the warp's butterfly
    (lane t holds row t; xor 1, 2, 4, 8, 16), the accumulators adding
    the valid rows in row order -> (max [G], sum [G], acc [G, hd])."""
    G, hd = qg.shape
    S = len(ok_row)
    m = torch.full((G,), NEG)
    l = torch.zeros(G)
    acc = torch.zeros(G, hd)
    for base in range(s_begin, s_end, TILE_WIDE):
        rows = base + _LANES
        ok = (rows < s_end) & ok_row[rows.clamp(max=S - 1)]
        if not ok.any():
            continue
        kr, vr = read(b, kh, rows[ok])
        k = torch.zeros(TILE_WIDE, hd)
        v = torch.zeros(TILE_WIDE, hd)
        k[ok], v[ok] = kr.float(), vr.float()
        s = torch.where(ok, qg @ k.T, torch.tensor(NEG))       # [G, 32]
        m_new = torch.maximum(m, s.amax(1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        ps = p
        for o in (1, 2, 4, 8, 16):
            ps = ps + ps[:, _LANES ^ o]
        l = l * corr + ps[:, 0]
        acc = acc * corr[:, None]
        for t in torch.nonzero(ok).flatten().tolist():
            acc = acc + p[:, t, None] * v[t]
        m = m_new
    return m, l, acc


def _split_decode(q, read, kv_pos, cur, S, window=0, fault=None):
    """The kernel's arithmetic in its order, in f32: q [B,H,hd];
    ``read(b, kh, rows)`` -> K and V rows [n, hd] of logical ``rows``;
    kv_pos [B,S] int; cur [B] -> out [B,H,hd].  The body
    ``decode_body`` names (narrow at G = 1 and hd <= 128, GQA at G > 1,
    wide above hd 128), over spans of ``span_rows(hd)`` rows.  ``fault``
    breaks the combine on purpose: ("drop", s) leaves span s out,
    ("no_rescale", None) merges the spans without their exp(m_s - M)
    factors."""
    B, H, hd = q.shape
    K = read.K
    G = H // K
    span = tda.span_rows(hd)
    qs = q.float() / math.sqrt(hd)
    plan = tda.decode_span_plan(B, H, S, hd)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        ok_row = ((kv_pos[b] >= 0) & (kv_pos[b] <= cur[b])
                  & ((cur[b] - kv_pos[b] < window) if window else True))
        for kh in range(K):
            # the narrow body takes one head a block, the GQA and the wide
            # bodies up to 16
            body = {"narrow": _narrow_span, "gqa": _gqa_span,
                    "wide": _wide_span}[tda.decode_body(H, K, hd)]
            step = {_narrow_span: 1, _gqa_span: HEADS_GQA,
                    _wide_span: HEADS_WIDE}[body]
            for g0 in range(0, G, step):
                qg = qs[b, kh * G + g0:kh * G + min(G, g0 + step)]
                parts = []
                for sp in range(plan.spans):
                    s_begin, s_end = sp * span, min(S, sp * span + span)
                    parts.append(body(qg, read, b, kh, ok_row, s_begin,
                                      s_end))
                out[b, kh * G + g0:kh * G + g0 + len(qg)] = _combine(
                    parts, plan.spans, fault)
    return out


def _combine(parts, spans, fault):
    """One span's result written directly, or the spans merged in span
    order as combine_kernel merges them."""
    if spans == 1:
        mx, tot, num = parts[0]
        return num / torch.clamp(tot, min=1e-30)[:, None]
    M = torch.full_like(parts[0][0], NEG)
    for mx, _, _ in parts:
        M = torch.maximum(M, mx)
    tot, num = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for sp, (mx, t, n) in enumerate(parts):
        if fault == ("drop", sp):
            continue
        c = torch.exp(mx - M)
        if fault == ("no_rescale", None):
            c = torch.ones_like(c)
        tot = tot + t * c
        num = num + n * c[:, None]
    return num / torch.clamp(tot, min=1e-30)[:, None]


def _contiguous(k, v):
    """A row reader over a cache k/v [B,K,S,hd]."""
    def read(b, kh, rows):
        return k[b, kh, rows], v[b, kh, rows]
    read.K = k.shape[1]
    return read


def _paged(k, v, bs, seed):
    """The same rows in a shuffled pool [1 + B*S/bs, bs, K, hd] whose
    block 0 is trash (1e3), read through a table as the paged kernel
    reads them: logical row s -> pool row tbl[b, s // bs] * bs + s % bs."""
    B, K, S, hd = k.shape
    mb = S // bs
    perm = np.random.default_rng(seed).permutation(B * mb) + 1
    tbl = torch.from_numpy(perm.reshape(B, mb))
    pools = []
    for x in (k, v):
        pool = torch.full((1 + B * mb, bs, K, hd), 1e3)
        pool[tbl] = x.transpose(1, 2).reshape(B, mb, bs, K, hd)
        pools.append(pool.reshape(-1, K, hd))

    def read(b, kh, rows):
        prow = tbl[b, rows // bs] * bs + rows % bs
        return pools[0][prow, kh], pools[1][prow, kh]
    read.K = K
    return read


def _decode_inputs(B, H, K, S, hd, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    col = np.arange(S)[None]
    n = np.asarray(lengths)[:, None]
    kv = np.where(col < n, col, -1).astype(np.int32)
    cur = (n[:, 0] - 1).astype(np.int32)
    return q, k, v, kv, cur


# (B, H, K, S, hd, valid rows per slot): one span, the serving shape's
# few valid rows, GQA; two and three spans; a ragged last span; the wide
# body at hd 256: paligemma's G = 8 at the serving shape, recurrentgemma's
# G = 10 over a 2048-row cache (16 spans); the GQA body at granite's 24
# over 8 heads of 64 (two spans), internlm2's and dbrx's G = 6 and
# llama3's G = 16 at 128, the smoke configuration's G = 4 at 16, and
# G = 20 (two groups of heads)
DECODE = {
    "serving_one_span": (3, 4, 4, 128, 80, [17, 31, 1]),
    "gqa_two_spans": (2, 8, 2, 2 * L, 32, [2 * L, 600]),
    "ragged_three_spans": (2, 4, 4, 2 * L + 128, 80, [2 * L + 128, 5]),
    "wide_g8_serving": (3, 8, 1, 128, 256, [17, 31, 1]),
    "wide_g10_sixteen_spans": (2, 10, 1, 2048, 256, [2048, 600]),
    "gqa_granite_two_spans": (2, 24, 8, L + 64, 64, [L + 64, 300]),
    "gqa_g6_hd128": (2, 12, 2, 256, 128, [256, 77]),
    "gqa_g16_hd128": (1, 32, 2, 256, 128, [200]),
    "gqa_smoke_g4_hd16": (3, 16, 4, 128, 16, [17, 31, 1]),
    "gqa_g20_two_groups": (1, 40, 2, 128, 64, [100]),
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_split_span_emulation_matches_ref(case):
    B, H, K, S, hd, lengths = DECODE[case]
    q, k, v, kv, cur = _decode_inputs(B, H, K, S, hd, lengths, 11)
    got = _split_decode(torch.from_numpy(q),
                        _contiguous(torch.from_numpy(k), torch.from_numpy(v)),
                        torch.from_numpy(kv), torch.from_numpy(cur), S)
    want = np.asarray(ref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv),
        jnp.asarray(cur)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra_spans", [1, 3])
@pytest.mark.parametrize("S,hd,H,K", [
    pytest.param(128, 80, 4, 2, id="128"),
    pytest.param(L + 64, 80, 4, 2, id=str(L + 64)),
    # the wide body: one span of 128 rows, and two
    pytest.param(128, 256, 10, 1, id="128-hd256"),
    pytest.param(192, 256, 10, 1, id="192-hd256"),
    # the narrow body (G = 1); the GQA body at granite's, G = 6 and 16 at
    # hd 128, the smoke configuration's G = 4 at 16
    pytest.param(128, 80, 4, 4, id="128-mha"),
    pytest.param(L + 64, 64, 24, 8, id=f"{L + 64}-granite"),
    pytest.param(128, 128, 12, 2, id="128-g6-hd128"),
    pytest.param(128, 128, 32, 2, id="128-g16-hd128"),
    pytest.param(128, 16, 16, 4, id="128-smoke-g4-hd16")])
def test_split_span_trailing_empty_spans_change_no_bit(S, hd, H, K,
                                                       extra_spans):
    """The same valid rows in a cache of S rows and in one of
    S + extra_spans spans' rows whose extra rows are empty: the same
    bytes, whether S is one span (out written directly) or two (the
    combine); in each body (at hd 256 with recurrentgemma's G = 10)."""
    B = 2
    lengths = [S, S // 2 + 3]
    q, k, v, kv, cur = _decode_inputs(B, H, K, S, hd, lengths, 12)
    S2 = S + extra_spans * tda.span_rows(hd)
    k2 = np.zeros((B, K, S2, hd), np.float32)
    v2 = np.zeros_like(k2)
    k2[:, :, :S], v2[:, :, :S] = k, v
    kv2 = np.full((B, S2), -1, np.int32)
    kv2[:, :S] = kv
    t = torch.from_numpy
    small = _split_decode(t(q), _contiguous(t(k), t(v)), t(kv), t(cur), S)
    big = _split_decode(t(q), _contiguous(t(k2), t(v2)), t(kv2), t(cur), S2)
    assert tda.decode_span_plan(B, H, S2, hd).spans > tda.decode_span_plan(
        B, H, S, hd).spans
    assert torch.equal(small, big)


W = tda.SPAN_WIDE
# (S, valid rows per slot, (H, K, hd)): G = 2 at hd 32 and G = 10 at 256
# over one span and two; granite's 24 over 8 of 64, G = 6 and 16 at 128,
# the smoke configuration's G = 4 at 16
PAGED_BASE = ((128, [100, 17], (4, 2, 32)),
              (2 * L, [2 * L - 5, 300], (4, 2, 32)),
              (W, [W - 28, 17], (10, 1, 256)),
              (4 * W, [4 * W - 5, 150], (10, 1, 256)))
PAGED_GQA = ((L + 128, [L + 100, 200], (24, 8, 64)),
             (256, [250, 33], (12, 2, 128)),
             (256, [256, 130], (32, 2, 128)),
             (128, [100, 17], (16, 4, 16)))


@pytest.mark.parametrize("bs,shapes", [
    pytest.param(1, PAGED_BASE, id="1"), pytest.param(16, PAGED_BASE, id="16"),
    pytest.param(128, PAGED_BASE, id="128"),
    pytest.param(1, PAGED_GQA, id="1-gqa"),
    pytest.param(16, PAGED_GQA, id="16-gqa"),
    pytest.param(128, PAGED_GQA, id="128-gqa")])
def test_split_span_paged_equals_contiguous(bs, shapes):
    """The paged layout changes only the row a key is read from: the
    same bytes as the contiguous cache, over one span and over two; at
    hd 32 and 256 (G = 2 and 10), and in the GQA body at granite's,
    llama3's, internlm2's and the smoke configuration's G."""
    for S, lengths, (H, K, hd) in shapes:
        B = 2
        q, k, v, kv, cur = _decode_inputs(B, H, K, S, hd, lengths, 13)
        t = torch.from_numpy
        contiguous = _split_decode(t(q), _contiguous(t(k), t(v)), t(kv),
                                   t(cur), S)
        paged = _split_decode(t(q), _paged(t(k), t(v), bs, 14), t(kv),
                              t(cur), S)
        assert torch.equal(contiguous, paged)


# ---------------------------------------------------------------------------
# the tensor-core flash prefill
# ---------------------------------------------------------------------------

BM = 64                # the tensor-core body's query rows per block
BN = 64                # and keys per tile (kBM, kBN in the source)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _tc_flash(q, k, v, *, causal=True, window=0, q_offset=0, drop_tile=None):
    """q [B,H,Sq,hd] and k/v [B,K,Skv,hd] in bf16 -> [B,H,Sq,hd] bf16, as
    the tensor-core body computes it: per 64-row query tile the visible
    64-key tiles, f32 scores in log2 units, one max and one rescale per
    row and tile, the sum of the f32 weights, P rounded to bf16 for
    O += P.V in f32.  ``drop_tile`` (a key tile's first key) is a fault
    on purpose: every query tile skips that key tile."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd) * math.log2(math.e)
    out = torch.empty(B, H, Sq, hd, dtype=torch.bfloat16)
    kf, vf = k.float(), v.float()
    for q0 in range(0, Sq, BM):
        rows = torch.arange(q0, min(q0 + BM, Sq))
        last = int(rows[-1])
        k_end = min(Skv, last + q_offset + 1) if causal else Skv
        k_begin = max(0, q0 + q_offset - window + 1) if window else 0
        k_begin = k_begin // BN * BN
        qp = rows + q_offset
        m = torch.full((B, H, len(rows)), NEG)
        lsum = torch.zeros(B, H, len(rows))
        o = torch.zeros(B, H, len(rows), hd)
        for k0 in range(k_begin, k_end, BN):
            if k0 == drop_tile:
                continue
            keys = torch.arange(k0, k0 + BN)
            kt = torch.zeros(B, K, BN, hd)
            vt = torch.zeros(B, K, BN, hd)
            n = min(BN, Skv - k0)
            kt[:, :, :n] = kf[:, :, k0:k0 + n]
            vt[:, :, :n] = vf[:, :, k0:k0 + n]
            kt = kt.repeat_interleave(G, dim=1)
            vt = vt.repeat_interleave(G, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(), kt)
            s = s * scale
            ok = keys[None] < Skv
            if causal:
                ok = ok & (keys[None] <= qp[:, None])
            if window:
                ok = ok & (qp[:, None] - keys[None] < window)
            s = torch.where(ok, s, torch.tensor(NEG))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            lsum = lsum * corr + p.sum(-1)
            pb = p.to(torch.bfloat16).float()
            o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", pb, vt)
            m = m_new
        out[:, :, rows] = (o / torch.clamp(lsum, min=1e-30)[..., None]).to(
            torch.bfloat16)
    return out


# (B, H, K, Sq, Skv, hd, causal, window, q_offset)
FLASH = {
    "hd64_causal_ragged": (1, 2, 2, 100, 100, 64, True, 0, 0),
    "hd80_causal_ragged_gqa": (1, 4, 2, 150, 150, 80, True, 0, 0),
    "hd128_window_gqa": (1, 4, 1, 200, 200, 128, True, 48, 0),
    "hd80_window_offset": (1, 2, 2, 70, 110, 80, True, 37, 40),
    "hd64_full_ragged": (1, 2, 2, 65, 129, 64, False, 0, 0),
    "hd128_serving_prompt": (2, 2, 2, 16, 16, 128, True, 0, 0),
    # hd 256: recurrentgemma's G = 10 over one kv head, windowed and
    # ragged; causal, ragged, with an offset; paligemma's serving prompt
    "hd256_window_g10_ragged": (1, 10, 1, 150, 150, 256, True, 48, 0),
    "hd256_causal_offset": (1, 2, 1, 70, 110, 256, True, 0, 40),
    "hd256_serving_prompt_g8": (2, 8, 1, 16, 16, 256, True, 0, 0),
}


def _within_budget(got, want, v):
    """The tensor-core arithmetic's error budget: P rounded to bf16 moves
    each weight by at most 2^-8 (bf16's unit roundoff) of itself, so the
    output by at most 2^-8 max|v|, and the output's own bf16 rounding by
    2^-8 of itself.  On unit-normal inputs (max|v| < 5, outputs below 3)
    that is at most 0.032, the size of the card's absolute bf16
    tolerance of 3e-2; the card's limit relative to each row is held in
    ``test_row_tolerance_*``."""
    vmax = v.float().abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2 ** -8, atol=2 ** -8 * vmax)


@pytest.mark.parametrize("case", sorted(FLASH))
def test_tensor_core_flash_emulation_matches_ref(case):
    B, H, K, Sq, Skv, hd, causal, window, off = FLASH[case]
    assert hd in tfa.TC_HEAD_DIMS
    rng = np.random.default_rng(21)
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd)))
    kw = dict(causal=causal, window=window, q_offset=off)
    got = _tc_flash(q, k, v, **kw)
    # the oracle in f32 over the same bf16 values
    want = np.asarray(ref.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), **kw))
    _within_budget(got, want, v)
    # and the card's limit, each row against its largest output
    assert row_scaled_error(got, torch.tensor(want)) <= ATTN_BF16_ROW_TOL
    # and with the port's plain version, the card's reference, in f32
    plain = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    _within_budget(got, plain, v)


def test_tensor_core_rounding_is_what_the_budget_covers():
    """The emulation differs from the f32 plain version (P and the
    output are rounded) and stays inside the budget."""
    rng = np.random.default_rng(22)
    B, H, S, hd = 1, 2, 192, 80
    q, k, v = (_bf16(rng.standard_normal((B, H, S, hd)).astype(np.float32))
               for _ in range(3))
    plain = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    tc = _tc_flash(q, k, v)
    assert (tc.float() - plain).abs().max().item() > 0
    _within_budget(tc, plain, v)


def test_tensor_core_wrapper_refuses_other_head_dims_on_cpu_tensors():
    # the kernel is chosen on the card; a CPU tensor is refused before
    # it, and the plain version takes any head dim
    q = torch.zeros(1, 2, 4, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_cuda(q, q, q)
    assert tfa.flash_attention(q, q, q).shape == q.shape
    assert 48 not in tfa.TC_HEAD_DIMS and 80 in tfa.TC_HEAD_DIMS
    assert tfa.body(torch.bfloat16, torch.bfloat16, 48) == "cuda_cores"


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,want", [
    (BF16, BF16, 64, "tensor_cores"), (BF16, BF16, 80, "tensor_cores"),
    (BF16, BF16, 96, "tensor_cores"), (BF16, BF16, 128, "tensor_cores"),
    # recurrentgemma's and paligemma's, the widest the kernel takes
    (BF16, BF16, 256, "tensor_cores"),
    # the smoke configurations' head dim, and others the body does not take
    (BF16, BF16, 32, "cuda_cores"), (BF16, BF16, 48, "cuda_cores"),
    (BF16, BF16, 192, "cuda_cores"),
    # an f32 operand: the f32 parity path
    (F32, F32, 80, "cuda_cores"), (F32, BF16, 80, "cuda_cores"),
    (BF16, F32, 128, "cuda_cores"),
])
def test_flash_body_by_types_and_head_dim(q_dtype, kv_dtype, hd, want):
    assert tfa.body(q_dtype, kv_dtype, hd) == want


# ---------------------------------------------------------------------------
# the card's bf16 limit
# ---------------------------------------------------------------------------

# chip_smoke.py's bf16 flash cases at 2 heads (B, H, K, S, hd, window)
CARD_FLASH = {
    "prefill_main": (8, 2, 2, 16, 80, 0),
    "prefill_long": (1, 2, 2, 2048, 80, 0),
    "prefill_long_hd64_bf16": (1, 2, 2, 2048, 64, 0),
    "prefill_ragged_bf16": (1, 2, 2, 1000, 80, 0),
    "prefill_gqa_window_bf16": (1, 4, 1, 512, 128, 128),
    # recurrentgemma's prefill_hybrid at hd 256 and G = 10, its prompt and
    # window cut to 600 and 256 (the card's: 3,000 and 2048)
    "prefill_hybrid_short": (1, 10, 1, 600, 256, 256),
}


def _card_flash_inputs(case):
    B, H, K, S, hd, window = CARD_FLASH[case]
    rng = np.random.default_rng(23)
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd)))
    plain = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      window=window)
    return q, k, v, window, plain


@pytest.mark.parametrize("case", sorted(CARD_FLASH))
def test_row_tolerance_covers_the_tensor_core_arithmetic(case):
    q, k, v, window, plain = _card_flash_inputs(case)
    assert row_scaled_error(_tc_flash(q, k, v, window=window),
                            plain) <= ATTN_BF16_ROW_TOL / 2


@pytest.mark.parametrize("case", ["prefill_long", "prefill_ragged_bf16",
                                  "prefill_gqa_window_bf16",
                                  "prefill_hybrid_short"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_row_tolerance_fails_a_dropped_key_tile(case, where):
    """A query tile that skips one key tile, the first or the last one
    the last query tile sees (the long rows, whose outputs are the
    smallest), fails the card's limit."""
    q, k, v, window, plain = _card_flash_inputs(case)
    S = q.shape[2]
    last_q0 = (S - 1) // BN * BN
    first = max(0, last_q0 - window + 1) // BN * BN if window else 0
    tile = first if where == "first" else last_q0 - BN
    got = _tc_flash(q, k, v, window=window, drop_tile=tile)
    assert row_scaled_error(got[:, :, last_q0:],
                            plain[:, :, last_q0:]) > ATTN_BF16_ROW_TOL


def _long_decode(S, seed):
    """One slot whose S rows are all valid, in bf16 values (the card's
    decode_long_b1 at 2 heads), the f32 plain result, and the reader."""
    q, k, v, kv, cur = _decode_inputs(1, 2, 2, S, 80, [S], seed)
    q, k, v = (_bf16(x).float() for x in (q, k, v))
    t = torch.from_numpy
    want = tda.decode_attention_plain(q, k, v, t(kv), t(cur))
    return q, _contiguous(k, v), t(kv), t(cur), want


def test_row_tolerance_covers_the_split_decode():
    S = 8 * L
    q, read, kv, cur, want = _long_decode(S, 24)
    got = _split_decode(q, read, kv, cur, S).to(torch.bfloat16)
    assert row_scaled_error(got, want) <= ATTN_BF16_ROW_TOL / 2


@pytest.mark.parametrize("fault", [("drop", 0), ("drop", 7),
                                   ("no_rescale", None)])
def test_row_tolerance_fails_a_broken_span_merge(fault):
    """decode_long_b1's 8 spans: one left out of the merge, or all
    merged without their rescale, fails the card's limit."""
    S = 8 * L
    q, read, kv, cur, want = _long_decode(S, 24)
    got = _split_decode(q, read, kv, cur, S, fault=fault)
    assert row_scaled_error(got.to(torch.bfloat16),
                            want) > ATTN_BF16_ROW_TOL


def test_row_scaled_error_is_relative_to_each_row():
    want = torch.tensor([[[1.0, -2.0], [0.01, 0.0]], [[0.0, 0.0],
                                                       [3.0, 4.0]]])
    got = want.clone()
    assert row_scaled_error(got, want) == 0.0
    got[0, 1, 1] = 0.001              # 0.1 of that row's largest
    assert row_scaled_error(got, want) == pytest.approx(0.1)
    got = want.clone()
    got[1, 0, 0] = 0.25               # an all-zero row: absolute
    assert row_scaled_error(got, want) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def _fake_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\nint f() { return g(); }\n')
    (csrc / "a.cuh").write_text('#include "b.cuh"\n'
                                'inline int g() { return h(); }\n')
    (csrc / "b.cuh").write_text("inline int h() { return 1; }\n")
    return csrc


def test_library_hash_follows_included_headers(tmp_path):
    csrc = _fake_csrc(tmp_path)
    assert [p.name for p in build.local_headers("k", csrc)] == ["a.cuh",
                                                                "b.cuh"]
    before = build.library_path("k", tmp_path, csrc)
    assert before == build.library_path("k", tmp_path, csrc)
    (csrc / "b.cuh").write_text("inline int h() { return 2; }\n")
    after = build.library_path("k", tmp_path, csrc)
    assert after != before and after.name.startswith("k-")


# the headers a kernel may include: the CUDA toolkit's and the C library's
TOOLKIT_HEADERS = {"cuda.h", "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h",
                   "stdint.h", "math.h", "float.h"}


@pytest.mark.parametrize("name", build.KERNELS)
def test_every_kernel_builds_from_the_repository_alone(name, tmp_path):
    """No kernel needs a header outside the repository and the CUDA
    toolkit, and every ``nvcc`` command is the same flags."""
    src = (build.CSRC / f"{name}.cu").read_text()
    system = set(re.findall(r"^\s*#\s*include\s*<([^>]+)>", src, re.M))
    assert system <= TOOLKIT_HEADERS, system - TOOLKIT_HEADERS
    for header in build.local_headers(name):
        assert header.parent == build.CSRC and header.exists()
    out = tmp_path / f"{name}.so"
    assert build.nvcc_command("nvcc", name, out) == [
        "nvcc", *build.NVCC_FLAGS, "-o", str(out),
        str(build.CSRC / f"{name}.cu")]
    assert build.library_path(name, tmp_path).name.startswith(f"{name}-")
