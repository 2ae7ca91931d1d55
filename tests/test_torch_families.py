"""The MoE and MLA model families in the port against the reference, on
the CPU: granite-moe-3b-a800m (attention + MoE), minicpm3-4b (MLA,
scaled and tied embeddings) and dbrx-132b (attention + MoE, LayerNorm,
untied) at their smoke configs.

Models: f32 weights from the reference's ``init_lm``, carried across by
``convert.lm_from_numpy`` (the experts' stacked [L, E, D, F] leaves
included); ``forward`` logits and aux loss, ``prefill`` logits, cache
and positions, and ``decode_step`` at a scalar and a [B] position,
within 2e-4 (the tolerance of ``tests/test_models.py``), f32 caches.

Engines: the port's ``ContinuousBatchingEngine`` against the
reference's on one seeded trace (more requests than the 3 slots,
prompts of 3 to 12 tokens, mixed budgets), f32 caches on both sides
(``init_cache``'s dtype patched, as ``tests/test_torch_decode_window.py``
does): granite on the contiguous and the paged pool, greedy and sampled,
with tokens dropped by the router (counted on the port's side: at 3
slots a decode step routes 3 tokens into experts of 2 rows); minicpm3
on the contiguous pool, greedy and sampled; granite with ``draft_depth``
2 against the reference's speculative engine.  The same tokens for
every request.  Also: ``pool_hbm_bytes`` equal to the reference's, the
reference's errors for a paged or speculative MLA engine, the
launcher end to end, and what still raises (``check_supported``).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jfull  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import sampling as js  # noqa: E402
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
    ``layers/mix/w_uk`` [L, r, H, nope]) land in each layer's module; a
    missing, extra or misshapen leaf raises."""
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
    np.testing.assert_array_equal(model.layers[1].mix.w_uk.numpy(),
                                  flat["layers/mix/w_uk"][1])
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
    (DBRX, True)])
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
    (DBRX, ["--draft-depth", "2"])])
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


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "paligemma-3b",
                                  "whisper-medium"])
def test_other_families_still_raise_naming_item_12(arch):
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        ttfm.check_supported(tget(arch))
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tcont.pool_hbm_bytes(tget(arch), 2, 32)
