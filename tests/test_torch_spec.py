"""The port's self-speculative decode against the reference's, on the
CPU.

The stablelm-3b smoke config (2 layers, d 128) in f32 with a one-layer
draft prefix (``draft_layers=1``), params from the reference's
``init_lm`` carried across with ``convert.lm_from_numpy``; caches f32 on
both sides (``init_cache``'s dtype patched, as
``tests/test_torch_decode_window.py`` does), so the only difference
left between the two sides' logits is sum order.

Pieces: ``cache_write_chunk`` (k, v and pos equal, clamped spills
included), ``chunk_attend`` (1e-6, and ``decode_attend`` itself at
S = 1), ``decode_chunk`` logits and cache (1e-5), ``draft_prefix``
logits, the chunk kernel entry's plain version (row j is
``decode_attention_plain`` at ``start + j``, byte for byte) and
``DraftDepthController.decide`` (exactly equal over one sequence of
observations).

Engines: the port's ``ContinuousBatchingEngine(draft_depth=D)`` and the
reference's on one seeded trace, greedy and sampled (``SP`` of
``tests/test_spec_decode.py``), D = 1 and 3, with aligned params (the
last layer zeroed: high acceptance) and seeded ones (low acceptance):
the same tokens and every spec stat equal; and the same tokens as the
port's own non-speculative engine.  Refill waves with an EOS id; the
near-``max_seq`` case (max_seq 16, prompts of 8 decoding to the
``max_seq - 1`` stop, D = 3 and 4: drafts written in place past the
cache's last row clamp there, and the prompt rows of the draft's layers
keep their positions); and the live depth moving between windows
through one ``depth_cap`` tensor.  The reference's engines are built
once per (depth, max_seq) and shared (their windows compile once); each
run gets a fresh ``DraftDepthController``, as a fresh engine has.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import sampling as js  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402

ARCH = "stablelm-3b"
SP = dict(temperature=0.9, top_k=20, top_p=0.95, seed=7)
SLOTS, MAX_SEQ, SYNC = 4, 64, 2
SPEC_STATS = ("mode", "decode_steps", "occupied_slot_steps", "host_syncs",
              "prefill_calls", "tokens_generated", "draft_depth",
              "draft_depth_live", "draft_layers", "spec_proposed",
              "spec_accepted", "acceptance_rate", "accepted_per_step",
              "energy_per_token_model")


def _configs(**kw):
    return (jget(ARCH).replace(dtype="float32", remat=False, draft_layers=1,
                               **kw),
            tget(ARCH).replace(dtype="float32", draft_layers=1, **kw))


def _aligned(params):
    """The reference's ``_aligned_params``: the LAST layer's params
    zeroed, so its residual block is the identity and the one-layer
    draft agrees with the full model almost everywhere."""
    pz = dict(params)
    pz["layers"] = jax.tree_util.tree_map(lambda x: x.at[-1].set(0.0),
                                          params["layers"])
    return pz


@pytest.fixture(scope="module")
def lm():
    """(jcfg, tcfg, {"seeded"|"aligned": (jax params, port model)})."""
    jcfg, tcfg = _configs()
    seeded = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    out = {}
    for name, params in (("seeded", seeded), ("aligned", _aligned(seeded))):
        out[name] = (params, convert.lm_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jcfg, tcfg, out


@pytest.fixture
def f32_caches(monkeypatch):
    monkeypatch.setattr(jtfm, "init_cache", functools.partial(
        jtfm.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(ttfm, "init_cache", functools.partial(
        ttfm.init_cache, dtype=torch.float32))


@pytest.fixture(scope="module")
def ref_engines(lm):
    """The reference's spec engines by (depth, max_seq), built on first
    use and shared by the tests of this file."""
    engines = {}

    def get(depth, max_seq=MAX_SEQ):
        key = (depth, max_seq)
        if key not in engines:
            engines[key] = jcont.ContinuousBatchingEngine(
                lm[0], lm[2]["seeded"][0], n_slots=SLOTS, max_seq=max_seq,
                sync_every=SYNC, draft_depth=depth)
        return engines[key]
    return get


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("starts", [[0, 2, 1], [5, 6, 7], [9, 3, 12]],
                         ids=["inside", "spill", "past_the_end"])
def test_cache_write_chunk_matches_jax(starts):
    """S = 4 rows per slot into an 8-row cache: rows past C-1 clamp onto
    C-1 (the last chunk row wins there); k, v and pos equal the
    reference's."""
    B, C, S, K, hd = 3, 8, 4, 2, 8
    rng = np.random.default_rng(1)
    k0, v0 = (rng.standard_normal((B, C, K, hd)).astype(np.float32)
              for _ in range(2))
    pos0 = np.where(np.arange(C)[None] < 3, np.arange(C)[None], -1)
    pos0 = np.repeat(pos0, B, 0).astype(np.int32)
    kn, vn = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
              for _ in range(2))
    start = np.asarray(starts, np.int32)
    jc = jattn.cache_write_chunk(
        jattn.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                      pos=jnp.asarray(pos0), length=jnp.int32(3)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start))
    tc = tattn.KVCache(k=torch.from_numpy(k0.copy()),
                       v=torch.from_numpy(v0.copy()),
                       pos=torch.from_numpy(pos0.copy()))
    out = tattn.cache_write_chunk(tc, torch.from_numpy(kn),
                                  torch.from_numpy(vn),
                                  torch.from_numpy(start).long())
    assert out is tc
    np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
    np.testing.assert_array_equal(np.asarray(jc.v), tc.v.numpy())
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())
    if starts[1] + S > C:                     # a clamped spill: last wins
        assert int(tc.pos[1, C - 1]) == starts[1] + S - 1
        np.testing.assert_array_equal(tc.k[1, C - 1].numpy(), kn[1, S - 1])


@pytest.mark.parametrize("window", [0, 5])
def test_chunk_attend_matches_jax_and_decode_attend_at_s1(window):
    B, C, S, H, K, hd = 2, 12, 4, 4, 2, 8
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, K, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.where(np.arange(C)[None] < np.array([[9], [6]]),
                   np.arange(C)[None], -1).astype(np.int32)
    qpos = (np.array([[5], [6]]) + np.arange(S)[None]).astype(np.int32)
    want = jattn.chunk_attend(
        jnp.asarray(q), jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                      pos=jnp.asarray(pos), length=None),
        qpos=jnp.asarray(qpos), window=window)
    tc = tattn.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                       pos=torch.from_numpy(pos))
    got = tattn.chunk_attend(torch.from_numpy(q), tc,
                             qpos=torch.from_numpy(qpos), window=window)
    assert _err(want, got.numpy()) < 1e-6
    one = tattn.chunk_attend(torch.from_numpy(q[:, :1]), tc,
                             qpos=torch.from_numpy(qpos[:, :1]),
                             window=window)
    step = tattn.decode_attend(torch.from_numpy(q[:, :1]), tc,
                               pos=torch.from_numpy(qpos[:, 0]),
                               window=window)
    assert torch.equal(one, step)
    # the kernel entry's plain version (``impl="ref"``) attends alike
    ref = tattn.chunk_attend_kernel(torch.from_numpy(q), tc,
                                    start=torch.from_numpy(qpos[:, 0]),
                                    window=window, impl="ref")
    assert _err(want, ref.numpy()) < 1e-6


@pytest.mark.parametrize("window", [0, 4], ids=["full", "window4"])
def test_decode_chunk_matches_jax(lm, window):
    """Prefill 8 tokens into a 12-row f32 cache, then a 4-token chunk at
    per-row positions 8 and 10 (the second clamps two rows onto row 11):
    logits and the whole cache as the reference's."""
    jcfg = _configs(window=window)[0]
    params = lm[2]["seeded"][0]
    tcfg = lm[1].replace(window=window)
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jc = jtfm.init_cache(jcfg, 2, 12, dtype=jnp.float32)
    tc = ttfm.init_cache(tcfg, 2, 12, torch.float32, device="cpu")
    _, jc = jtfm.prefill(jcfg, params, jnp.asarray(toks[:, :8]), jc)
    model.prefill(toks[:, :8], tc)
    pos = np.array([8, 10], np.int32)
    jl, jc = jtfm.decode_chunk(jcfg, params, jnp.asarray(toks[:, 8:]), jc,
                               jnp.asarray(pos))
    tl, tc = model.decode_chunk(toks[:, 8:], tc, torch.from_numpy(pos))
    assert tl.shape == (2, 4, jcfg.vocab)
    assert _err(jl, tl.numpy()) < 1e-5
    assert _err(jc.layers.kv.k, tc.k.numpy()) < 1e-5
    assert _err(jc.layers.kv.v, tc.v.numpy()) < 1e-5
    np.testing.assert_array_equal(np.asarray(jc.layers.kv.pos),
                                  tc.pos.numpy())
    assert int(tc.length) == int(jc.length) == 14


def test_draft_prefix_matches_jax(lm):
    """The one-layer draft's decode step equals the reference's over the
    first layer of the same cache, and shares the model's tensors."""
    jcfg, _, models = lm
    params, model = models["seeded"]
    draft = model.draft_prefix(1)
    assert len(draft.layers) == 1 and len(model.layers) == 2
    assert draft.layers[0].mix.wq is model.layers[0].mix.wq
    assert draft.emb is model.emb and draft.unemb is model.unemb
    assert sum(p.numel() for p in draft.parameters()) < sum(
        p.numel() for p in model.parameters())
    with pytest.raises(ValueError, match="0 < n < n_layers"):
        model.draft_prefix(2)
    with pytest.raises(ValueError, match="0 < n < n_layers"):
        model.draft_prefix(0)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 9)).astype(
        np.int32)
    jc = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    tc = ttfm.init_cache(model.cfg, 2, 16, torch.float32, device="cpu")
    _, jc = jtfm.prefill(jcfg, params, jnp.asarray(toks[:, :8]), jc)
    model.prefill(toks[:, :8], tc)
    jd = jtfm.Cache(layers=jax.tree_util.tree_map(lambda x: x[:1],
                                                  jc.layers),
                    length=jc.length)
    pos = np.array([8, 8], np.int32)
    jl, _ = jtfm.decode_step(jcfg, jtfm.draft_prefix(jcfg, params, 1),
                             jnp.asarray(toks[:, 8:]), jd, jnp.asarray(pos))
    tl, _ = draft.decode_step(toks[:, 8:], tc, torch.from_numpy(pos))
    assert _err(jl, tl.numpy()) < 1e-5
    # the draft wrote layer 0 only
    assert int(tc.pos[0, 0, 8]) == 8 and int(tc.pos[1, 0, 8]) == -1


@pytest.mark.parametrize("case", ["serving", "spans", "clamped"])
def test_chunk_plain_rows_are_single_queries(case):
    """``decode_attention_chunk_plain`` row j is ``decode_attention_plain``
    at ``start + j`` over the same cache, byte for byte: at the serving
    layout (17-31 valid rows of 32), past the kernel's span length, and
    with two cache rows holding the same clamped position."""
    B, n, H, K, hd = 3, 4, 4, 2, 16
    S = {"serving": 32, "spans": tda.SPAN + 40, "clamped": 16}[case]
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, n, H, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, K, S, hd)).astype(
        np.float32)) for _ in range(2))
    lengths = {"serving": [17, 24, 31], "spans": [S, S - 3, 600],
               "clamped": [16, 16, 12]}[case]
    col = torch.arange(S)[None]
    kv_pos = torch.where(col < torch.tensor(lengths)[:, None], col,
                         -1).int()
    start = torch.tensor(lengths).int() - n
    if case == "clamped":                    # a spill: row 15 holds 17
        kv_pos[:2, S - 1] = 17
        start[:2] = S - 2
    got = tda.decode_attention_chunk_plain(q, k, v, kv_pos, start)
    assert got.shape == (B, n, H, hd)
    for j in range(n):
        want = tda.decode_attention_plain(q[:, j], k, v, kv_pos, start + j)
        assert torch.equal(got[:, j], want), j
    assert torch.equal(tops.decode_attention_chunk(q, k, v, kv_pos, start),
                       got)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tops.decode_attention_chunk(q, k, v, kv_pos, start, impl="cuda")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tda.decode_attention_chunk_cuda(q, k, v, kv_pos, start)


def test_draft_depth_controller_matches_jax():
    """``decide()`` and the acceptance state equal the reference's after
    every observation of one sequence, at two prices and a brownout."""
    rng = np.random.default_rng(6)
    obs = [(int(a), int(p)) for p, a in
           ((p, rng.integers(0, p + 1)) for p in rng.integers(0, 40, 30))]
    for kw in (dict(max_depth=3, draft_cost=0.25),
               dict(max_depth=5, draft_cost=0.5, alpha=0.4),
               dict(max_depth=4, draft_cost=0.25, tau_scale=0.3)):
        j, t = jctl.DraftDepthController(**kw), tctl.DraftDepthController(**kw)
        assert t.decide() == j.decide()
        for a, p in obs:
            j.observe(accepted=a, proposed=p)
            t.observe(accepted=a, proposed=p)
            assert t.decide() == j.decide()
            assert t.acceptance == j.acceptance
        assert t.history == j.history
        assert t.acceptance_rate == j.acceptance_rate
    # the prior picks depth 1 at c = 8/32, and high acceptance widens it
    c = tctl.DraftDepthController(max_depth=3, draft_cost=8 / 32)
    assert c.decide() == 1
    for _ in range(12):
        c.observe(accepted=400, proposed=400)
    assert c.decide() == 3


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(vocab, n=6, plen=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen) for _ in range(n)]


def _reqs(mod, prompts, sp=None, max_new=None, eos=None):
    return [mod.GenRequest(rid=i, prompt=p,
                           max_new=(4 + (i % 4)) if max_new is None
                           else max_new,
                           eos_id=eos, sampling=sp)
            for i, p in enumerate(prompts)]


def _ref_serve(je, params, prompts, sp=None, **kw):
    """One run of a shared reference engine, as a fresh one would run."""
    je.params = params
    je.spec_controller = jctl.DraftDepthController(
        max_depth=je.draft_depth,
        draft_cost=je.cfg.draft_layers / je.cfg.n_layers)
    reqs = _reqs(jcont, prompts, None if sp is None
                 else js.SamplingParams(**sp), **kw)
    stats = je.serve(reqs, prompt_len=8)
    return [r.generated for r in reqs], stats


def _port_serve(tcfg, model, prompts, sp=None, depth=0, max_seq=MAX_SEQ,
                **kw):
    eng = tcont.ContinuousBatchingEngine(
        tcfg if depth else tcfg.replace(draft_layers=0), model,
        n_slots=SLOTS, max_seq=max_seq, sync_every=SYNC, draft_depth=depth,
        device="cpu")
    reqs = _reqs(tcont, prompts, None if sp is None
                 else ts.SamplingParams(**sp), **kw)
    stats = eng.serve(reqs, prompt_len=8)
    return [r.generated for r in reqs], stats, eng


@pytest.mark.parametrize("weights", ["aligned", "seeded"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_engine_matches_jax(lm, ref_engines, f32_caches, mode, depth,
                                 weights):
    jcfg, tcfg, models = lm
    params, model = models[weights]
    sp = SP if mode == "sampled" else None
    prompts = _prompts(jcfg.vocab)
    want, jstats = _ref_serve(ref_engines(depth), params, prompts, sp)
    got, tstats, eng = _port_serve(tcfg, model, prompts, sp, depth)
    assert got == want
    for key in SPEC_STATS:
        assert tstats[key] == jstats[key], key
    assert tstats["mode"] == "spec" and tstats["window"] == "eager"
    assert eng.decode_capture_count == 0
    # lossless: the port's own non-speculative engine, as lists
    plain, pstats, _ = _port_serve(tcfg, model, prompts, sp)
    assert got == plain and pstats["mode"] == "fused"
    if weights == "aligned" and mode == "greedy":
        assert tstats["acceptance_rate"] > 0.5
        assert tstats["energy_per_token_model"] < 1.0
    if weights == "seeded":
        assert tstats["acceptance_rate"] < 0.5


def test_spec_across_refill_waves_and_eos(lm, ref_engines, f32_caches):
    """Seven requests over four slots with an EOS id: retirement inside
    the verify chunk folds into the done masks across refill waves."""
    jcfg, tcfg, models = lm
    params, model = models["seeded"]
    prompts = _prompts(jcfg.vocab, n=7, seed=3)
    probe, _, _ = _port_serve(tcfg, model, prompts, max_new=6)
    eos = probe[2][2]                           # a token some stream emits
    want, jstats = _ref_serve(ref_engines(3), params, prompts, max_new=6,
                              eos=eos)
    got, tstats, _ = _port_serve(tcfg, model, prompts, depth=3, max_new=6,
                                 eos=eos)
    assert got == want
    assert any(len(g) < 6 and g[-1] == eos for g in got)
    assert tstats["prefill_calls"] >= 2
    for key in SPEC_STATS:
        assert tstats[key] == jstats[key], key
    plain, _, _ = _port_serve(tcfg, model, prompts, max_new=6, eos=eos)
    assert got == plain


@pytest.mark.parametrize("depth", [3, 4])
def test_spec_near_max_seq(lm, ref_engines, f32_caches, depth):
    """max_seq 16, prompts of 8, budgets past the ``max_seq - 1`` stop,
    seeded weights (drafts rejected): every draft past the cache's last
    row is written in place, clamped onto it.  Tokens and stats equal
    the reference's (which drafts on a scratch copy), and after every
    window the prompt rows of the draft's layers hold their positions:
    a draft written with the ring write (``pos % C``) would have put
    positions 16.. there, and the verify's query at ``pos`` would have
    lost row 0."""
    jcfg, tcfg, models = lm
    params, model = models["seeded"]
    prompts = _prompts(jcfg.vocab, n=SLOTS, seed=4)
    want, jstats = _ref_serve(ref_engines(depth, 16), params, prompts,
                              max_new=20)
    eng = tcont.ContinuousBatchingEngine(
        tcfg, model, n_slots=SLOTS, max_seq=16, sync_every=SYNC,
        draft_depth=depth, device="cpu")
    reqs = _reqs(tcont, prompts, max_new=20)
    sess = eng.start_session(8)
    for r in reqs:
        sess.push(r)
    dl, windows = tcfg.draft_layers, 0
    while not sess.idle:
        sess.advance()
        windows += 1
        prompt_pos = sess._pool.pos[:dl, :, :8]
        assert torch.equal(prompt_pos, torch.arange(8, dtype=torch.int32)
                           .expand_as(prompt_pos)), windows
    assert [r.generated for r in reqs] == want
    assert all(len(g) == 16 - 1 - 8 + 1 for g in want)  # ran to the stop
    stats = sess.stats()
    for key in SPEC_STATS:
        if key in stats:
            assert stats[key] == jstats[key], key
    assert stats["acceptance_rate"] < 0.5


def test_live_depth_moves_through_one_depth_cap(lm):
    """The controller's live depth changes between windows of one
    session (from the prior's depth 1 upward as the aligned draft is
    accepted); every window reads it from the same ``depth_cap`` tensor,
    and no macro-step accepts more drafts than the live depth."""
    jcfg, tcfg, models = lm
    model = models["aligned"][1]
    eng = tcont.ContinuousBatchingEngine(tcfg, model, n_slots=SLOTS,
                                         max_seq=MAX_SEQ, sync_every=SYNC,
                                         draft_depth=3, device="cpu")
    sess = eng.start_session(8)
    cap = sess._depth_cap
    for r in _reqs(tcont, _prompts(jcfg.vocab, n=SLOTS), max_new=24):
        sess.push(r)
    depths = []
    while not sess.idle:
        before = sess.spec_accepted, sess.occupied_slot_steps
        sess.advance()
        depths.append(sess.last_depth)
        assert sess._depth_cap is cap and int(cap) == sess.last_depth
        acc = sess.spec_accepted - before[0]
        assert acc <= (sess.occupied_slot_steps - before[1]) * depths[-1]
    assert depths[0] == 1 and len(set(depths)) >= 2


def test_spec_constructor_refusals_match_jax(lm):
    """The reference's checks, in its order, with its messages."""
    jcfg, tcfg, models = lm
    params, model = models["seeded"]
    cases = [(dict(), -1), (dict(kv_block_size=8), 2),
             (dict(draft_layers=0), 2)]
    for kw, depth in cases:
        with pytest.raises(ValueError) as je:
            jcont.ContinuousBatchingEngine(jcfg.replace(**kw), params,
                                           n_slots=2, max_seq=32,
                                           draft_depth=depth)
        with pytest.raises(ValueError) as te:
            tcont.ContinuousBatchingEngine(tcfg.replace(**kw), model,
                                           n_slots=2, max_seq=32,
                                           draft_depth=depth, device="cpu")
        assert str(te.value) == str(je.value)
    eng = tcont.ContinuousBatchingEngine(tcfg, model, draft_depth=3,
                                         device="cpu")
    assert eng.spec_controller.max_depth == 3
    assert eng.spec_controller.draft_cost == 0.5
    assert eng.current_depth() == 1


def test_launcher_spec_on_cpu(tmp_path):
    """``--mode generate --smoke --draft-depth 2`` end to end on the CPU:
    every request answered, the spec stats in the summary, the draft
    prefix resolved to ``n_layers - 1``."""
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--smoke", "--draft-depth",
         "2", "--requests", "6", "--new-tokens", "4", "--slots", "2",
         "--runs", str(tmp_path)])
    summary, server = tserve.serve_generate(args)
    assert sorted(r.rid for r in server.responses) == list(range(6))
    for r in server.responses:
        if r.admitted:
            assert 1 <= len(r.output) <= 4
    assert summary["mode"] == "spec" and summary["draft_depth"] == 2
    assert summary["draft_layers"] == 1
    for key in ("acceptance_rate", "accepted_per_step",
                "energy_per_token_model", "draft_depth_live"):
        assert key in summary, key
    assert 0.0 <= summary["acceptance_rate"] <= 1.0
    assert summary["accepted_per_step"] >= 1.0
    assert 1 <= summary["draft_depth_live"] <= 2
