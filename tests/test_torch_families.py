"""The model families in the port against the reference, on the CPU:
granite-moe-3b-a800m (attention + MoE), minicpm3-4b (MLA, scaled and
tied embeddings), dbrx-132b (attention + MoE, LayerNorm, untied),
recurrentgemma-2b (RG-LRU and windowed attention in one stack),
paligemma-3b (a prefix-LM, with and without its patch embeddings) and
whisper-medium (encoder-decoder) at their smoke configs.

Models: f32 weights from the reference's ``init_lm``, carried across by
``convert.lm_from_numpy`` (stacked leaves, a mixed stack's list of
layers, the encoder's and cross-attention's stacks); ``forward`` logits
and aux loss, ``prefill`` logits, cache and positions, and
``decode_step`` at a scalar and a [B] position, within 2e-4 (the
tolerance of ``tests/test_models.py``), f32 caches; prefill + decode
against the port's own forward; recurrentgemma's ring decoding past its
window.

Engines: the port's ``ContinuousBatchingEngine`` against the
reference's on one seeded trace (more requests than the 3 slots,
prompts of 3 to 12 tokens, mixed budgets), f32 caches on both sides
(``init_cache``'s dtype patched, as ``tests/test_torch_decode_window.py``
does): granite on the contiguous and the paged pool, greedy and sampled,
with tokens dropped by the router (counted on the port's side: at 3
slots a decode step routes 3 tokens into experts of 2 rows); minicpm3,
recurrentgemma and paligemma on the contiguous pool, greedy and
sampled, paligemma also paged and at ``draft_depth`` 2; granite with
``draft_depth`` 2 against the reference's speculative engine, and with
one slot drafting at the ``max_seq - 1`` stop while others decode.  The
same tokens for every request.  Also: ``pool_hbm_bytes`` equal to the
reference's, the reference's errors for a paged or speculative MLA or
mixed engine, whisper refused by the engine, and the launcher end to
end.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jfull  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import sampling as js  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tfull  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402

TOL = 2e-4
GRANITE, MINICPM, DBRX = "granite-moe-3b-a800m", "minicpm3-4b", "dbrx-132b"
RG, PALI, WHISPER = "recurrentgemma-2b", "paligemma-3b", "whisper-medium"
SLOTS, MAX_SEQ = 3, 48
MAX_NEW = [5, 9, 3, 12, 6, 2, 8, 7]
SP = dict(temperature=0.9, top_k=20, top_p=0.95, seed=7)


@functools.lru_cache(maxsize=None)
def _pair(arch, **kw):
    jcfg = jget(arch).replace(dtype="float32", **kw)
    tcfg = tget(arch).replace(dtype="float32", **kw)
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - b.float().numpy()).max())


@pytest.mark.parametrize("arch", [GRANITE, MINICPM, DBRX])
def test_lm_matches_jax(arch):
    jcfg, params, tcfg, model = _pair(arch)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 11)).astype(
        np.int32)
    f1, a1 = jtfm.forward(jcfg, params, jnp.asarray(toks))
    f2, a2 = model.forward(toks)
    assert f2.shape == (2, 11, jcfg.vocab) and _err(f1, f2) < TOL
    assert abs(float(a1) - float(a2)) < 1e-5
    assert (float(a2) > 0) == jcfg.is_moe
    c1 = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    c2 = ttfm.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    p1, c1 = jtfm.prefill(jcfg, params, jnp.asarray(toks[:, :8]), c1)
    p2, c2 = model.prefill(toks[:, :8], c2)
    assert _err(p1, p2) < TOL
    kv = c1.layers.kv
    if arch == MINICPM:
        assert c2.latent and c2.k is None
        assert _err(kv.c_kv, c2.c_kv) < TOL
        assert _err(kv.k_rope, c2.k_rope) < TOL
    else:
        assert _err(kv.k, c2.k) < TOL and _err(kv.v, c2.v) < TOL
    np.testing.assert_array_equal(np.asarray(kv.pos), c2.pos.numpy())
    for j, per_slot in enumerate([False, True, True]):
        t = toks[:, 8 + j:9 + j]
        pos = 8 + j
        jp = jnp.full((2,), pos, jnp.int32) if per_slot else pos
        tp = torch.full((2,), pos) if per_slot else pos
        d1, c1 = jtfm.decode_step(jcfg, params, jnp.asarray(t), c1, jp)
        d2, c2 = model.decode_step(t, c2, tp)
        assert _err(d1, d2) < TOL, j


def test_moe_and_mla_trees_carry_across_and_mismatches_raise():
    """The reference's stacked leaves (``layers/moe/w_gate`` [L, E, D, F],
    ``layers/mix/w_uk`` [L, r, H, nope], held as [r, H * nope]) land in
    each layer's module; a missing, extra or misshapen leaf raises."""
    jcfg, params, tcfg, model = _pair(GRANITE)
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    np.testing.assert_array_equal(model.layers[1].moe.w_down.numpy(),
                                  flat["layers/moe/w_down"][1])
    assert model.layers[0].moe.router.dtype == torch.float32
    missing = {k: v for k, v in flat.items() if k != "layers/moe/router"}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_from_numpy(tcfg, missing, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.lm_from_numpy(tcfg, {**flat, "layers/mlp/w_up":
                                     flat["layers/moe/w_up"][:, 0]},
                              device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.lm_from_numpy(tcfg, {**flat, "layers/moe/w_gate":
                                     flat["layers/moe/w_gate"][:, :3]},
                              device="cpu")
    jcfg, params, tcfg, model = _pair(MINICPM)
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    # the port holds the reference's [r, H, nope] as [r, H * nope]
    w_uk = flat["layers/mix/w_uk"][1]
    np.testing.assert_array_equal(model.layers[1].mix.w_uk.numpy(),
                                  w_uk.reshape(w_uk.shape[0], -1))
    # bf16 weights keep their exact values, the router stays f32
    tree = jax.tree.map(np.asarray, jtfm.init_lm(jget(GRANITE),
                                                 jax.random.PRNGKey(2)))
    bf = convert.lm_from_numpy(tget(GRANITE), tree, device="cpu")
    assert bf.layers[0].moe.w_up.dtype == torch.bfloat16
    assert bf.layers[0].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        bf.layers[1].moe.w_up.float().numpy(),
        np.asarray(tree["layers"]["moe"]["w_up"][1], np.float32))


def _prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 13, size=len(MAX_NEW))]


def _requests(mod, prompts, sp=None):
    return [mod.GenRequest(rid=i, prompt=p, max_new=m, sampling=sp)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


@pytest.fixture
def f32_caches(monkeypatch):
    monkeypatch.setattr(jtfm, "init_cache", functools.partial(
        jtfm.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(ttfm, "init_cache", functools.partial(
        ttfm.init_cache, dtype=torch.float32))


@pytest.fixture
def dropped(monkeypatch):
    """Tokens the port's router dropped, summed over every MoE call."""
    count = [0]
    route = tmoe.route

    def counting(*a, **kw):
        out = route(*a, **kw)
        count[0] += int((~out[4]).sum())
        return out

    monkeypatch.setattr(tmoe, "route", counting)
    return count


def _engines(arch, sampled, paged=False, draft=0):
    kw = dict(draft_layers=1) if draft else {}
    jcfg, params, tcfg, model = _pair(arch, **kw)
    if paged:
        jcfg = jcfg.replace(kv_block_size=8)
        tcfg = tcfg.replace(kv_block_size=8)
    prompts = _prompts(jcfg.vocab)
    je = jcont.ContinuousBatchingEngine(jcfg, params, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, sync_every=4,
                                        draft_depth=draft)
    jr = _requests(jcont, prompts, js.SamplingParams(**SP) if sampled
                   else None)
    jstats = je.serve(jr)
    te = tcont.ContinuousBatchingEngine(tcfg, model, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, sync_every=4,
                                        device="cpu", draft_depth=draft)
    tr = _requests(tcont, prompts, ts.SamplingParams(**SP) if sampled
                   else None)
    tstats = te.serve(tr)
    return [r.generated for r in jr], [r.generated for r in tr], jstats, \
        tstats


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_granite_engine_matches_jax(f32_caches, dropped, paged, sampled):
    want, got, jstats, tstats = _engines(GRANITE, sampled, paged)
    assert got == want
    assert dropped[0] > 0
    assert tstats["mode"] == ("paged" if paged else "fused")
    for key in ("decode_steps", "occupied_slot_steps", "prefill_calls"):
        assert tstats[key] == jstats[key], key


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_minicpm3_engine_matches_jax(f32_caches, sampled):
    want, got, jstats, tstats = _engines(MINICPM, sampled)
    assert got == want
    assert tstats["decode_steps"] == jstats["decode_steps"]


def test_granite_speculative_engine_matches_jax_speculative(f32_caches):
    """The reference's speculative tokens (not its non-speculative ones:
    the verify chunk routes B * (D + 1) tokens in one group, so what an
    expert drops differs from a step's) and its spec stats."""
    want, got, jstats, tstats = _engines(GRANITE, False, draft=2)
    assert got == want
    assert tstats["mode"] == "spec"
    for key in ("spec_proposed", "spec_accepted", "decode_steps"):
        assert tstats[key] == jstats[key], key


STOP_SEQ, STOP_PLEN = 12, 4
STOP_NEW = [40, 3, 5, 30, 30]      # request 0 runs into the max_seq - 1 stop


@pytest.mark.parametrize("depth", [2, 4])
def test_granite_spec_draft_at_the_stop_matches_jax(f32_caches, depth):
    """Request 0 decodes into the ``max_seq - 1`` stop while requests 3
    and 4, seated in a later wave, still decode: the stopped slot keeps
    drafting inside each window, at positions past the cache's last row
    (where the reference's scratch draft wraps onto the first rows), and
    an MoE router groups its draft tokens with the live slots'.  The
    port's tokens and spec stats against the reference's, greedy, f32
    caches.  On this trace a draft that clamps at the last row instead
    of wrapping accepts one draft more than the reference at D = 4."""
    jcfg, params, tcfg, model = _pair(GRANITE, draft_layers=1)
    rng = np.random.default_rng(13)
    rng.integers(1, 4), rng.integers(1, 6)      # the draws of two budgets
    prompts = [rng.integers(0, jcfg.vocab, size=STOP_PLEN).astype(np.int32)
               for _ in STOP_NEW]
    out, stats = {}, {}
    for mod, cfg, p, kw in ((jcont, jcfg, params, {}),
                            (tcont, tcfg, model, dict(device="cpu"))):
        eng = mod.ContinuousBatchingEngine(cfg, p, n_slots=SLOTS,
                                           max_seq=STOP_SEQ, sync_every=4,
                                           draft_depth=depth, **kw)
        reqs = [mod.GenRequest(rid=i, prompt=pr, max_new=m)
                for i, (pr, m) in enumerate(zip(prompts, STOP_NEW))]
        stats[mod] = eng.serve(reqs, prompt_len=STOP_PLEN)
        out[mod] = [r.generated for r in reqs]
    assert out[tcont] == out[jcont]
    assert len(out[tcont][0]) == STOP_SEQ - STOP_PLEN    # ran to the stop
    for key in ("spec_proposed", "spec_accepted", "decode_steps",
                "occupied_slot_steps"):
        assert stats[tcont][key] == stats[jcont][key], key


def test_moe_prefill_pads_to_the_reference_bucket():
    """An MoE wave prefills the reference's power-of-two bucket of rows
    (its zero-token rows are routed with the prompts); other stacks only
    the real rows."""
    moe_eng = tcont.ContinuousBatchingEngine(
        _pair(GRANITE)[2], _pair(GRANITE)[3], n_slots=SLOTS,
        max_seq=MAX_SEQ, device="cpu")
    mla_eng = tcont.ContinuousBatchingEngine(
        _pair(MINICPM)[2], _pair(MINICPM)[3], n_slots=SLOTS,
        max_seq=MAX_SEQ, device="cpu")
    assert [moe_eng.prefill_rows(n) for n in (1, 2, 3, 5)] == [1, 2, 4, 8]
    assert [mla_eng.prefill_rows(n) for n in (1, 2, 3, 5)] == [1, 2, 3, 5]


@pytest.mark.parametrize("arch,paged", [
    (GRANITE, False), (GRANITE, True), (MINICPM, False), (DBRX, False),
    (DBRX, True), (RG, False), (PALI, False), (PALI, True),
    (WHISPER, False)])
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
def test_pool_hbm_bytes_matches_jax(arch, paged, full):
    jc = (jfull if full else jget)(arch)
    tc = (tfull if full else tget)(arch)
    if paged:
        jc, tc = (c.replace(kv_block_size=16) for c in (jc, tc))
    assert tcont.pool_hbm_bytes(tc, 8, 128) == jcont.pool_hbm_bytes(jc, 8,
                                                                     128)


def test_paged_and_speculative_mla_raise_the_reference_errors():
    jcfg, params, tcfg, model = _pair(MINICPM)
    for mod, cfg, p in ((jcont, jcfg, params), (tcont, tcfg, model)):
        kw = {} if mod is jcont else dict(device="cpu")
        # the reference refuses when its session builds the pool, the
        # port when the engine is built
        with pytest.raises(ValueError, match="paged KV pool"):
            mod.ContinuousBatchingEngine(cfg.replace(kv_block_size=8), p,
                                         n_slots=2, max_seq=32,
                                         **kw).start_session()
        with pytest.raises(ValueError, match="pure attention stack"):
            mod.ContinuousBatchingEngine(cfg.replace(draft_layers=1), p,
                                         n_slots=2, max_seq=32,
                                         draft_depth=2, **kw)
    with pytest.raises(ValueError, match="decode_chunk needs a pure"):
        model.decode_chunk(np.zeros((1, 2), np.int32),
                           ttfm.init_cache(tcfg, 1, 8, device="cpu"), 0)


@pytest.mark.parametrize("arch,extra", [
    (GRANITE, []), (GRANITE, ["--kv-block-size", "8"]), (MINICPM, []),
    (DBRX, ["--draft-depth", "2"]), (RG, []), (PALI, []),
    (PALI, ["--kv-block-size", "8"]), (PALI, ["--draft-depth", "2"])])
def test_launcher_serves_the_families(tmp_path, arch, extra):
    """``--mode generate --arch <family> --smoke`` end to end on the CPU,
    with no new flag: every request answered, token ids inside the
    vocabulary, the pool's bytes as ``pool_hbm_bytes`` counts them."""
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--arch", arch, "--smoke",
         "--requests", "5", "--new-tokens", "3", "--slots", "2", "--runs",
         str(tmp_path), *extra])
    summary, server = tserve.serve_generate(args)
    cfg = tserve.generate_config(args)
    resp = sorted(server.responses, key=lambda r: r.rid)
    assert [r.rid for r in resp] == list(range(5))
    for r in resp:
        if r.admitted:
            assert 1 <= len(r.output) <= 3
            assert all(0 <= t < cfg.vocab for t in r.output)
    assert summary["arch"] == tget(arch).arch_id
    assert summary["kv_pool_bytes"] == tcont.pool_hbm_bytes(
        cfg, 2, tserve.GEN_MAX_SEQ)["total_bytes"]


# ---------------------------------------------------------------------------
# recurrentgemma-2b (RG-LRU + windowed attention), paligemma-3b (prefix-LM)
# and whisper-medium (encoder-decoder)
# ---------------------------------------------------------------------------

def _frontends(cfg, batch, prefix):
    """Seeded frame embeddings (an encoder-decoder) or patch embeddings
    (a prefix-LM with ``prefix``), 0.1-scaled, as ``tests/test_models.py``
    makes them: (the reference's kwargs, the port's)."""
    rng = np.random.default_rng(3)
    if cfg.family == "encdec":
        name, shape = "enc_embeds", (batch, cfg.enc_seq, cfg.d_model)
    elif prefix:
        name, shape = "prefix_embeds", (batch, cfg.n_patches, cfg.d_model)
    else:
        return {}, {}
    x = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return {name: jnp.asarray(x)}, {name: torch.from_numpy(x)}


def _cache_errs(cfg, c1, c2) -> list[float]:
    """Every cache leaf's largest difference, layer by layer (the
    reference's list of per-layer caches on a mixed stack), positions
    equal."""
    errs = []
    for i, (kind, j) in enumerate(c2.index):
        lc = c1.layers[i] if not cfg.homogeneous else None
        if kind == "kv":
            kv = lc.kv if lc is not None else c1.layers.kv
            pick = (lambda a: a) if lc is not None else (lambda a: a[i])
            errs += [_err(pick(kv.k), c2.k[j]), _err(pick(kv.v), c2.v[j])]
            np.testing.assert_array_equal(np.asarray(pick(kv.pos)),
                                          c2.pos[j].numpy())
        else:
            errs += [_err(lc.rec.h, c2.lru_h[j]),
                     _err(lc.rec.conv, c2.lru_conv[j])]
    if c2.cross is not None:
        errs += [_err(c1.cross[0], c2.cross_k), _err(c1.cross[1], c2.cross_v)]
    return errs


# the reference's modes compiled once per config (its eager dispatch of a
# mixed stack takes ten times longer)
jforward = jax.jit(jtfm.forward, static_argnums=0)
jprefill = jax.jit(jtfm.prefill, static_argnums=0)
jdecode = jax.jit(jtfm.decode_step, static_argnums=0)
NEW_CASES = [(RG, False), (PALI, False), (PALI, True), (WHISPER, False)]
NEW_IDS = ["recurrentgemma", "paligemma-text", "paligemma-prefix", "whisper"]


@pytest.mark.parametrize("arch,prefix", NEW_CASES, ids=NEW_IDS)
def test_new_families_match_jax(arch, prefix):
    """forward, prefill and three decode steps (a scalar and two [B]
    positions), f32 weights and caches, within TOL of the reference's
    logits and caches; and prefill + decode against the port's own
    forward (``tests/test_models.py``'s
    ``test_arch_prefill_decode_matches_forward``)."""
    jcfg, params, tcfg, model = _pair(arch)
    B, S = 2, 12
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    jkw, tkw = _frontends(jcfg, B, prefix)
    P = jcfg.n_patches if prefix else 0
    f1, _ = jforward(jcfg, params, jnp.asarray(toks), **jkw)
    f2, _ = model.forward(toks, **tkw)
    assert f2.shape == (B, S, jcfg.vocab) and _err(f1, f2) < TOL
    c1 = jtfm.init_cache(jcfg, B, 32, dtype=jnp.float32)
    c2 = ttfm.init_cache(tcfg, B, 32, torch.float32, device="cpu")
    p1, c1 = jprefill(jcfg, params, jnp.asarray(toks[:, :S - 3]), c1, **jkw)
    p2, c2 = model.prefill(toks[:, :S - 3], c2, **tkw)
    assert _err(p1, p2) < TOL
    assert _err(p2[:, 0], f2[:, S - 4]) < TOL
    assert max(_cache_errs(jcfg, c1, c2)) < TOL
    for j, per_slot in enumerate([False, True, True]):
        pos = P + S - 3 + j
        t = toks[:, S - 3 + j:S - 2 + j]
        jp = jnp.full((B,), pos, jnp.int32) if per_slot else pos
        tp = torch.full((B,), pos) if per_slot else pos
        d1, c1 = jdecode(jcfg, params, jnp.asarray(t), c1, jp)
        d2, c2 = model.decode_step(t, c2, tp)
        assert _err(d1, d2) < TOL, j
        assert _err(d2[:, 0], f2[:, S - 3 + j]) < TOL, j
    assert max(_cache_errs(jcfg, c1, c2)) < TOL


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_hybrid_ring_decodes_past_the_window(impl):
    """``tests/test_models.py:244``'s case: recurrentgemma's ring of 16
    rows (window 16, max_seq 64), a 32-token prefill through the
    windowed attention (S > window) and 8 decode steps past it, each
    step's logits within TOL of forward's row and of the reference's
    step; ``"ref"`` takes the kernels' plain versions (the windowed
    flash and the ring's flash-decode) where ``"auto"`` takes the
    einsum path."""
    jcfg, params, tcfg, model = _pair(RG)
    S = 40
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (1, S)).astype(
        np.int32)
    model.attn_impl = impl
    try:
        full, _ = model.forward(toks)
        c1 = jtfm.init_cache(jcfg, 1, 64, dtype=jnp.float32)
        c2 = ttfm.init_cache(tcfg, 1, 64, torch.float32, device="cpu")
        assert c2.k.shape[2] == jcfg.window == 16
        _, c1 = jprefill(jcfg, params, jnp.asarray(toks[:, :32]), c1)
        _, c2 = model.prefill(toks[:, :32], c2)
        for i in range(32, S):
            t = toks[:, i:i + 1]
            d1, c1 = jdecode(jcfg, params, jnp.asarray(t), c1, i)
            d2, c2 = model.decode_step(t, c2, i)
            assert _err(d1, d2) < TOL, i
            assert _err(d2[:, 0], full[:, i]) < TOL, i
        assert sorted(c2.pos[0, 0].tolist()) == list(range(S - 16, S))
    finally:
        model.attn_impl = tcfg.attn_impl


def test_prefix_batch_stays_on_the_einsum_path(monkeypatch):
    """The reference's ``use_kernel`` rule: with the kernels forced
    (``"ref"``), a prefix batch still attends on the einsum path (the
    prefix mask) and a text-only batch of the same model takes the
    kernel dispatch; both within TOL of the einsum path's logits."""
    jcfg, params, tcfg, model = _pair(PALI)
    calls = [0]
    kernel = ttfm.attn.causal_attention_kernel

    def counting(*a, **kw):
        calls[0] += 1
        return kernel(*a, **kw)

    monkeypatch.setattr(ttfm.attn, "causal_attention_kernel", counting)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 6))
    _, tkw = _frontends(jcfg, 2, True)
    want = {k: model.forward(toks, **kw)[0] for k, kw in (("text", {}),
                                                           ("prefix", tkw))}
    model.attn_impl = "ref"
    try:
        got = model.forward(toks, **tkw)[0]
        assert calls[0] == 0
        assert torch.equal(got, want["prefix"])
        got = model.forward(toks)[0]
        assert calls[0] == jcfg.n_layers
        assert (got - want["text"]).abs().max() < TOL
    finally:
        model.attn_impl = tcfg.attn_impl


def test_family_trees_carry_across():
    """A mixed stack's list of layers, an encoder-decoder's stacked
    encoder and cross-attention land in their modules; a missing encoder
    leaf raises."""
    jcfg, params, tcfg, model = _pair(RG)
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    assert [layer.kind for layer in model.layers] == list(jcfg.block_kinds)
    np.testing.assert_array_equal(model.layers[2].mix.wq.numpy(),
                                  flat["layers/2/mix/wq"])
    np.testing.assert_array_equal(model.layers[1].mix.lam.numpy(),
                                  flat["layers/1/mix/lam"])
    jcfg, params, tcfg, model = _pair(WHISPER)
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    np.testing.assert_array_equal(model.encoder.layers[1].mlp.w_up.numpy(),
                                  flat["encoder/layers/mlp/w_up"][1])
    np.testing.assert_array_equal(model.xattn[1].mix.bk.numpy(),
                                  flat["xattn/mix/bk"][1])
    missing = {k: v for k, v in flat.items()
               if k != "encoder/final_norm/bias"}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_from_numpy(tcfg, missing, device="cpu")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch,paged,draft", [
    (RG, False, 0), (PALI, False, 0), (PALI, True, 0), (PALI, False, 2)],
    ids=["recurrentgemma", "paligemma", "paligemma-paged",
         "paligemma-spec"])
def test_new_family_engines_match_jax(f32_caches, arch, paged, draft,
                                      sampled):
    """The port's engine against the reference's on one trace (prompts of
    3 to 12 tokens, budgets to 12: recurrentgemma's 16-row rings wrap),
    f32 caches: the same tokens for every request and the same step
    counts (the speculative stats at D = 2)."""
    want, got, jstats, tstats = _engines(arch, sampled, paged, draft)
    assert got == want
    keys = ["decode_steps", "occupied_slot_steps", "prefill_calls"]
    if draft:
        keys += ["spec_proposed", "spec_accepted"]
    for key in keys:
        assert tstats[key] == jstats[key], key


def test_hybrid_and_encdec_engines_refuse_as_the_reference():
    """recurrentgemma: a paged pool and speculative decode raise the
    reference's errors.  whisper: the reference's engine fails inside its
    first prefill (it passes no encoder input); the port's raises a
    ValueError saying so when it is built."""
    jcfg, params, tcfg, model = _pair(RG)
    for mod, cfg, p in ((jcont, jcfg, params), (tcont, tcfg, model)):
        kw = {} if mod is jcont else dict(device="cpu")
        with pytest.raises(ValueError, match="paged KV pool"):
            mod.ContinuousBatchingEngine(cfg.replace(kv_block_size=8), p,
                                         n_slots=2, max_seq=32,
                                         **kw).start_session()
        with pytest.raises(ValueError, match="pure attention stack"):
            mod.ContinuousBatchingEngine(cfg.replace(draft_layers=1), p,
                                         n_slots=2, max_seq=32,
                                         draft_depth=2, **kw)
    with pytest.raises(ValueError, match="self-speculative drafting slices"):
        model.draft_prefix(1)
    with pytest.raises(ValueError, match="decode_chunk needs a pure"):
        model.decode_chunk(np.zeros((1, 2), np.int32),
                           ttfm.init_cache(tcfg, 1, 8, device="cpu"), 0)
    jcfg, params, tcfg, model = _pair(WHISPER)
    reqs = [jcont.GenRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                             max_new=2)]
    with pytest.raises(AttributeError):
        jcont.ContinuousBatchingEngine(jcfg, params, n_slots=2,
                                       max_seq=32).serve(reqs)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tcont.ContinuousBatchingEngine(tcfg, model, n_slots=2, max_seq=32,
                                       device="cpu")
    with pytest.raises(ValueError, match="decode_chunk needs a pure"):
        model.decode_chunk(np.zeros((1, 2), np.int32),
                           ttfm.init_cache(tcfg, 1, 8, device="cpu"), 0)


@pytest.mark.parametrize("arch,extra,match", [
    (WHISPER, [], "encoder-decoder"),
    (RG, ["--kv-block-size", "8"], "paged KV pool"),
    (RG, ["--draft-depth", "2"], "pure attention stack")],
    ids=["whisper", "hybrid-paged", "hybrid-spec"])
def test_launcher_refuses_what_the_engine_refuses(tmp_path, arch, extra,
                                                  match):
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--arch", arch, "--smoke",
         "--requests", "2", "--new-tokens", "2", "--slots", "2", "--runs",
         str(tmp_path), *extra])
    with pytest.raises(ValueError, match=match):
        tserve.serve_generate(args)


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_every_config_builds_and_runs(arch):
    """Every configuration builds as an ``LM`` (no family is refused any
    more) and its smoke config's forward gives finite logits of the
    tokens' shape, given the frontend input its family takes."""
    cfg = tget(arch)
    model = ttfm.init_lm(cfg, 0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 5))
    _, kw = _frontends(cfg, 2, cfg.family == "vlm")
    logits, _ = model.forward(toks, **kw)
    assert logits.shape == (2, 5, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
