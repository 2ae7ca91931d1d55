"""The MLA latent decode (``kernels.latent_decode``): its plain version,
the wrapper's refusals and the dispatch on the CPU; the CUDA kernel
against the plain version on the card.

On the CPU: ``latent_decode_plain`` is the einsum decode ``mla_decode``
ran before the kernel, bit for bit; the wrapper refuses what the kernel
has no instance for; a CPU decode never reaches the kernel; and an
emulation of the kernel's arithmetic (spans, 64-row tiles, the online
softmax in the log2 domain, P split into three bf16 parts, the span
merge) meets the plain version.  The tests marked ``chip`` need the H100
and skip without it (``python -m pytest tests/test_torch_latent_decode.py
-m chip`` on the card): the kernel against the plain version at
Moonlight's and MiniCPM3's shapes with bf16 and f32 caches, ragged live
lengths drawn as the benchmark's backlog draws them, a slot whose only
live row is its current one, a wrapped ring, holes and stale rows, and a
replay inside a CUDA graph.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

from repro_torch.kernels import build, graphs  # noqa: E402
from repro_torch.kernels import latent_decode as ld  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402

MOONLIGHT = dict(H=16, r=512, rope=64, nope=128)
MINICPM3 = dict(H=40, r=256, rope=32, nope=64)


def _old_mla_decode(p, x, cache, *, pos):
    """``mla_decode`` as it was before the kernel: the latent attention
    in einsum over the whole cache, written out here as it stood."""
    m = p.m
    B = x.shape[0]
    rope = mla._angles(m, mla._positions(pos, 1, x.device), x.device, None)
    c_kv, k_rope = mla._project_kv_latent(p, x, rope)
    mla._write(cache, c_kv, k_rope, pos)
    q_nope, q_rope = mla._project_q(p, x, rope)
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope,
                         mla._heads(p.w_uk, m.n_heads))
    c = cache.c_kv.float()
    kr = cache.k_rope.float()
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c)
              + torch.einsum("bthe,bse->bhts", q_rope.float(), kr))
    scores = scores * (1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim))
    cur = torch.as_tensor(pos, device=x.device)
    cur = cur[:, None] if cur.dim() == 1 else cur
    valid = (cache.pos >= 0) & (cache.pos <= cur)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", w, c)
    o = torch.einsum("bthr,rhv->bthv", o_lat,
                     mla._heads(p.w_uv, m.n_heads).float())
    return o.to(x.dtype).reshape(B, 1, -1) @ p.wo, cache


def _layer(dtype, *, H=4, r=32, rope=16, nope=16, d=64, seed=0):
    m = mla.MLAConfig(n_heads=H, q_lora_rank=24, kv_lora_rank=r,
                      qk_nope_dim=nope, qk_rope_dim=rope, v_head_dim=16)
    p = mla.MLAParams(d, m, dtype=dtype)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():            # norms away from the identity
        for norm in (p.q_norm, p.kv_norm):
            norm.scale.normal_(0.0, 0.2,
                               generator=torch.Generator().manual_seed(1))
    return p


def _filled_cache(p, B, C, dtype, cur, seed=0):
    """A cache whose rows hold seeded latents at their positions, each
    slot's rows [0, cur] written and one hole (-1) in slot 0."""
    cache = mla.init_mla_cache(B, C, p.m, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    cache.c_kv.copy_(torch.randn(cache.c_kv.shape, generator=g))
    cache.k_rope.copy_(torch.randn(cache.k_rope.shape, generator=g))
    for b in range(B):
        n = min(int(cur[b]) + 1, C)
        cache.pos[b, :n] = torch.arange(n, dtype=torch.int32)
    cache.pos[0, 1] = -1
    return cache


@pytest.mark.parametrize("mode", ["lockstep", "per_slot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_einsum_decode_bit_for_bit(mode, dtype):
    """``mla_decode`` on the CPU (the wrapper's plain version) gives the
    einsum decode's output and cache byte for byte."""
    B, C = 3, 24
    p = _layer(dtype)
    x = torch.randn(B, 1, 64, generator=torch.Generator().manual_seed(2)
                    ).to(dtype)
    if mode == "lockstep":
        pos, cur = 9, torch.full((B,), 9)
    else:
        cur = torch.tensor([9, 20, 3])
        pos = cur
    want_cache = _filled_cache(p, B, C, torch.bfloat16, cur - 1)
    got_cache = _filled_cache(p, B, C, torch.bfloat16, cur - 1)
    with torch.no_grad():
        want, _ = _old_mla_decode(p, x, want_cache, pos=pos)
        got, _ = mla.mla_decode(p, x, got_cache, pos=pos)
    assert torch.equal(got, want)
    for name in ("c_kv", "k_rope", "pos"):
        assert torch.equal(getattr(got_cache, name),
                           getattr(want_cache, name))


def _args(shape, B=2, C=8, *, qdt=torch.bfloat16, cdt=torch.bfloat16,
          n=1):
    H, r, rope = shape["H"], shape["r"], shape["rope"]
    return (torch.zeros(B, n, H, r, dtype=qdt),
            torch.zeros(B, n, H, rope, dtype=qdt),
            torch.zeros(B, C, r, dtype=cdt), torch.zeros(B, C, rope, dtype=cdt),
            torch.zeros(B, C, dtype=torch.int32))


REFUSED = {
    "latent_width": (dict(H=16, r=384, rope=64), {}, ValueError, "instances"),
    "rope_width": (dict(H=16, r=512, rope=32), {}, ValueError, "instances"),
    "too_many_heads": (dict(H=17, r=512, rope=64), {}, ValueError,
                       "instances"),
    "minicpm3_heads": (dict(H=49, r=256, rope=32), {}, ValueError,
                       "instances"),
    "float16": (MOONLIGHT, dict(cdt=torch.float16), TypeError, "float32 or"),
    "float64_q": (MOONLIGHT, dict(qdt=torch.float64), TypeError, "float32 or"),
    "two_tokens": (MOONLIGHT, dict(n=2), ValueError, r"\[B,1,H,r\]"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    shape, kw, err, match = REFUSED[case]
    with pytest.raises(err, match=match):
        ld.latent_decode_cuda(*_args(shape, **kw), 0, scale=0.1)


def test_wrapper_refuses_mixed_cache_types_mismatches_and_cpu_tensors():
    q, qr, c, kr, kp = _args(MOONLIGHT)
    with pytest.raises(TypeError, match="share a dtype"):
        ld.latent_decode_cuda(q, qr, c, kr.float(), kp, 0, scale=0.1)
    with pytest.raises(ValueError, match="do not agree"):
        ld.latent_decode_cuda(q, qr, c, kr, kp[:, :4], 0, scale=0.1)
    with pytest.raises(ValueError, match="do not agree"):
        ld.latent_decode_cuda(q, qr[:1], c, kr, kp, 0, scale=0.1)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ld.latent_decode_cuda(q, qr, c, kr, kp, 0, scale=0.1)
    with pytest.raises(ValueError, match="impl"):
        ld.latent_decode(q, qr, c, kr, kp, 0, scale=0.1, impl="xla")


@pytest.mark.parametrize("attn_impl", ["auto", "xla", "ref"])
def test_cpu_decode_never_reaches_the_kernel(attn_impl, monkeypatch):
    """A minicpm3-shaped model decoding on the CPU takes the plain
    version under every ``attn_impl``: the kernel entry is never called
    and no launch is counted."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm

    def refuse(*a, **k):
        raise AssertionError("the CUDA latent decode ran on the CPU")

    monkeypatch.setattr(ld, "latent_decode_cuda", refuse)
    before = dict(launches=ld.launches, merge=ld.merge_launches)
    cfg = get_smoke_config("minicpm3-4b")
    model = tfm.init_lm(cfg, 0, device="cpu")
    model.attn_impl = attn_impl
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5))
    cache = tfm.init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        model.prefill(prompts, cache)
        tok = torch.zeros(2, 1, dtype=torch.long)
        model.decode_step(tok, cache, 5)
        model.decode_step(tok, cache, torch.tensor([6, 6]))
    assert dict(launches=ld.launches, merge=ld.merge_launches) == before


def test_the_kernel_is_built_and_counted_with_the_others():
    assert "latent_decode" in build.KERNELS
    assert (build.CSRC / "latent_decode.cu").exists()
    counts = graphs.launch_counts()
    assert {"latent_decode.launches", "latent_decode.merge_launches"} <= set(
        counts)
    src = (build.CSRC / "latent_decode.cu").read_text()
    # the benchmark's decode-attention readers match kernels by these
    # substrings: the latent kernels must not carry them
    for needle in ("decode_kernel", "decode_wide_kernel", "combine_kernel"):
        assert needle not in src
    assert "latent_attn_kernel" in src and "latent_merge_kernel" in src
    assert f"kSpan = {ld.SPAN};" in src


@pytest.mark.parametrize("C,want", [(1, 1), (512, 1), (513, 2), (2048, 4),
                                    (4096, 8)])
def test_spans(C, want):
    assert ld.spans(C) == want


# --- the kernel's arithmetic, emulated ------------------------------------

def _split3(p):
    """P as three bf16 parts (the kernel's split of the weights)."""
    p1 = p.to(torch.bfloat16)
    r1 = p - p1.float()
    p2 = r1.to(torch.bfloat16)
    p3 = (r1 - p2.float()).to(torch.bfloat16)
    return p1, p2, p3


def test_three_bf16_parts_hold_a_weight_to_f32_precision():
    """p1 + p2 + p3 gives P to within 2^-24 of P (f32's own rounding),
    where one bf16 part is 2^-9 off: the weighted sum keeps the plain
    version's f32 weights."""
    p = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0))
    p = torch.cat([p, p * 1e-20, torch.tensor([0.0, 1.0])])
    p1, p2, p3 = _split3(p)
    err = (p1.double() + p2.double() + p3.double() - p.double()).abs()
    assert (err <= p.double() * 2.0 ** -24).all()
    assert ((p1.double() - p.double()).abs() > p.double() * 2.0 ** -12).any()


def _emulate(q_lat, q_rope, c_kv, k_rope, kv_pos, cur, scale, rows=64):
    """The kernel's schedule on the CPU in f32: spans of ``ld.SPAN`` rows
    cut at ``min(cur + 1, C)``, 64-row tiles, an online softmax in the
    log2 domain with masked rows at weight 0, the weighted sum of the
    three bf16 parts of P, the spans merged in span order."""
    B, _, H, r = q_lat.shape
    C = c_kv.shape[1]
    out = torch.zeros(B, 1, H, r)
    s2 = scale * math.log2(math.e)
    for b in range(B):
        live = max(0, min(int(cur[b]) + 1, C))
        q = torch.cat([q_lat[b, 0], q_rope[b, 0]], -1).float()     # [H, K]
        parts = []
        for row0 in range(0, max(live, 1), ld.SPAN):
            n = max(0, min(ld.SPAN, live - row0))
            m = torch.full((H,), -1e30)
            den = torch.zeros(H)
            acc = torch.zeros(H, r)
            for t0 in range(0, n, rows):
                sl = slice(row0 + t0, row0 + min(t0 + rows, n))
                kv = torch.cat([c_kv[b, sl], k_rope[b, sl]], -1).float()
                ok = (kv_pos[b, sl] >= 0) & (kv_pos[b, sl] <= cur[b])
                s = (q @ kv.T) * s2
                mx = torch.where(ok, s, -1e30).amax(-1)
                m_new = torch.maximum(m, mx)
                p = torch.where(ok, torch.exp2(s - m_new[:, None]), 0.0)
                al = torch.exp2(m - m_new)
                den = den * al + p.sum(-1)
                acc = acc * al[:, None] + sum(
                    part.float() @ c_kv[b, sl].float() for part in _split3(p))
                m = m_new
            parts.append((m, den, acc))
        if len(parts) == 1:
            m, den, acc = parts[0]
            out[b, 0] = acc / torch.where(den > 0, den, 1.0)[:, None] * (
                den > 0)[:, None]
            continue
        mx = torch.stack([pt[0] for pt in parts]).amax(0)
        w = [torch.exp2(pt[0] - mx) for pt in parts]
        den = sum(wi * pt[1] for wi, pt in zip(w, parts))
        acc = sum(wi[:, None] * pt[2] for wi, pt in zip(w, parts))
        out[b, 0] = acc / den[:, None]
    return out


def _case(shape, B, C, cdt, *, seed, wrap=True):
    """Inputs as the benchmark's backlog makes them: each slot's position
    a prompt of 64-1024 tokens plus up to 1,000 outputs, the rows
    [0, cur] at their positions, stale rows (pos > cur) above; slot 0
    with only its current row live, slot 1 a wrapped ring (cur past C),
    slot 2 with holes (-1) inside its live rows, slot 3 at C - 1 (every
    row live), slot 4 at a span's last row."""
    H, r, rope = shape["H"], shape["r"], shape["rope"]
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    cur = (rng.integers(64, 1025, B) + rng.integers(0, 1001, B) - 1)
    cur = np.minimum(cur, C - 1)
    cur[0] = 0
    if B > 4:
        cur[3], cur[4] = C - 1, min(ld.SPAN - 1, C - 1)
    if wrap:
        cur[1] = C + 700
    rows = np.arange(C)
    kv_pos = np.tile(rows, (B, 1))          # rows past cur: stale, pos > cur
    kv_pos[0, 1:] = np.where(rng.random(C - 1) < 0.5, -1, rows[1:] + 5)
    if wrap:
        kv_pos[1] = np.where(rows <= 700, rows + C, rows)
    kv_pos[2, 3:40] = -1
    q_lat = torch.randn(B, 1, H, r, generator=g)
    q_rope = torch.randn(B, 1, H, rope, generator=g)
    c_kv = torch.randn(B, C, r, generator=g).to(cdt)
    k_rope = torch.randn(B, C, rope, generator=g).to(cdt)
    qdt = torch.bfloat16 if cdt == torch.bfloat16 else torch.float32
    return (q_lat.to(qdt), q_rope.to(qdt), c_kv, k_rope,
            torch.from_numpy(kv_pos.astype(np.int32)),
            torch.from_numpy(cur.astype(np.int32)))


@pytest.mark.parametrize("shape,B,C", [(MOONLIGHT, 6, 1300),
                                       (MINICPM3, 6, 600)],
                         ids=["moonlight", "minicpm3"])
def test_emulated_schedule_meets_the_plain_version(shape, B, C):
    """The kernel's arithmetic, emulated on the CPU, against the plain
    version on bf16 inputs: the two differ by summation order and exp2
    against exp, a few units of f32 rounding in each weight, so 1e-5 of
    each row's largest output; a dropped row moves a row by ~1e-2, a
    span merged unscaled by its own size."""
    args = _case(shape, B, C, torch.bfloat16, seed=3)
    scale = 1.0 / math.sqrt(shape["nope"] + shape["rope"])
    want = ld.latent_decode_plain(*args, scale=scale)
    got = _emulate(*args, scale)
    err = ((got - want).abs().amax(-1)
           / want.abs().amax(-1).clamp_min(1e-30))
    assert err.max().item() <= 1e-5, err.max().item()


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    from repro_torch.kernels.runtime import is_hopper
    if not is_hopper():
        pytest.skip("the latent decode kernel is built for sm_90a")
    return torch.device("cuda")


# the kernel against the plain version, relative to each row's largest
# output (runtime.row_scaled_error): both take exact products of the same
# bf16 (or f32) values in f32 and differ by summation order, exp2 against
# exp and the three-part weights' last bit, about 1e-6 of a row at these
# lengths; 1e-4 leaves a margin near a hundred, while one dropped live row
# of ~1,000 moves a row by ~1e-2 and a lost span by its own size
ROW_TOL = 1e-4

CARD_CASES = {
    "moonlight_bf16": (MOONLIGHT, 256, 2048, torch.bfloat16),
    "moonlight_f32": (MOONLIGHT, 256, 2048, torch.float32),
    "minicpm3_bf16": (MINICPM3, 32, 4096, torch.bfloat16),
    "minicpm3_f32": (MINICPM3, 32, 4096, torch.float32),
}


def _on(dev, args):
    return tuple(a.to(dev) for a in args)


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_the_card(case, card):
    from repro_torch.kernels.runtime import row_scaled_error
    shape, B, C, cdt = CARD_CASES[case]
    args = _on(card, _case(shape, B, C, cdt, seed=11))
    scale = 1.0 / math.sqrt(shape["nope"] + shape["rope"])
    n0, m0 = ld.launches, ld.merge_launches
    got = ld.latent_decode(*args, scale=scale)
    torch.cuda.synchronize()
    want = ld.latent_decode_plain(*args, scale=scale)
    assert (ld.launches - n0, ld.merge_launches - m0) == (1, C > ld.SPAN)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert row_scaled_error(got, want) <= ROW_TOL


@pytest.mark.chip
def test_kernel_with_an_f32_query_on_a_bf16_cache(card):
    """An f32 model's query on a bf16 cache: the CUDA-core instance."""
    from repro_torch.kernels.runtime import row_scaled_error
    args = list(_case(MOONLIGHT, 16, 1024, torch.bfloat16, seed=5))
    args[0], args[1] = args[0].float(), args[1].float()
    args = _on(card, args)
    got = ld.latent_decode(*args, scale=0.07)
    want = ld.latent_decode_plain(*args, scale=0.07)
    assert row_scaled_error(got, want) <= ROW_TOL


@pytest.mark.chip
def test_lockstep_position_and_a_single_span(card):
    """A scalar position (the lockstep path) on a cache of one span: no
    merge, the kernel writes its output itself."""
    from repro_torch.kernels.runtime import row_scaled_error
    q, qr, c, kr, kp, _ = _case(MINICPM3, 8, 256, torch.bfloat16, seed=7,
                                wrap=False)
    kp = torch.arange(256, dtype=torch.int32).expand(8, 256).contiguous()
    args = _on(card, (q, qr, c, kr, kp))
    m0 = ld.merge_launches
    got = ld.latent_decode(*args, 200, scale=0.1)
    want = ld.latent_decode_plain(*args, 200, scale=0.1)
    assert ld.merge_launches == m0
    assert row_scaled_error(got, want) <= ROW_TOL


@pytest.mark.chip
def test_kernel_replays_in_a_cuda_graph(card):
    """Captured once and replayed on new positions and rows written in
    place (as the decode window does): each replay equals the plain
    version, and ``CountedGraph`` adds the launches at every replay."""
    from repro_torch.kernels.runtime import row_scaled_error
    args = list(_on(card, _case(MOONLIGHT, 64, 2048, torch.bfloat16,
                                seed=13)))
    scale = 1.0 / math.sqrt(192)
    box = {}

    def step():
        box["out"] = ld.latent_decode(*args, scale=scale)

    step()                                            # warm-up, build
    torch.cuda.synchronize()
    graph = graphs.CountedGraph()
    graph.capture(step)
    assert graph.launches == {"latent_decode.launches": 1,
                              "latent_decode.merge_launches": 1}
    for k in range(3):
        fresh = _on(card, _case(MOONLIGHT, 64, 2048, torch.bfloat16,
                                seed=20 + k))
        for a, f in zip(args, fresh):
            a.copy_(f)
        n0 = ld.launches
        graph.replay()
        torch.cuda.synchronize()
        assert ld.launches == n0 + 1
        want = ld.latent_decode_plain(*args, scale=scale)
        assert row_scaled_error(box["out"], want) <= ROW_TOL


@pytest.mark.chip
def test_mla_decode_on_the_card_takes_the_kernel(card):
    """One MLA layer at minicpm3's widths on the card: ``mla_decode``
    launches the kernel once and meets ``impl="ref"`` on the same cache."""
    from repro_torch.kernels.runtime import row_scaled_error
    p = _layer(torch.bfloat16, H=40, r=256, rope=32, nope=64, d=256).to(card)
    x = torch.randn(4, 1, 256, generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16).to(card)
    cur = torch.tensor([0, 17, 300, 900])
    caches = [_filled_cache(p, 4, 1024, torch.bfloat16, cur - 1)
              for _ in range(2)]
    caches = [mla.MLACache(c.c_kv.to(card), c.k_rope.to(card),
                           c.pos.to(card)) for c in caches]
    n0 = ld.launches
    with torch.no_grad():
        got, _ = mla.mla_decode(p, x, caches[0], pos=cur.to(card))
        want, _ = mla.mla_decode(p, x, caches[1], pos=cur.to(card),
                                 impl="ref")
    assert ld.launches == n0 + 1
    assert row_scaled_error(got.float(), want.float()) <= 2.0 ** -6
