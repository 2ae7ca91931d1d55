"""The port's paged-KV generate path against the reference, on the CPU.

Kernel module: ``gather_block_views`` equals the reference's exactly,
and ``paged_decode_attention_plain`` (the CPU side of the paged
kernel's dispatch) matches the TPU kernel in interpret mode and the
reference's ``ops.paged_decode_attention(impl="ref")`` within 1e-5 in
f32 (other sum orders; the online softmax against one softmax) on
shuffled tables, a window, a ragged partial table and GQA, with the
trash block filled with 1e3 so that a row read through a wrong table
entry is loud.  Rows of an empty slot are skipped: the TPU kernel gives
the mean of its masked rows, the CUDA kernel 0, and nothing reads them.
The CUDA kernel and the gather shim run only on the card
(``chip_smoke.py`` holds them there); here they must refuse CPU
tensors.

Model and serving: ``paged_cache_write`` and ``paged_slot_write`` leave
the same pool, positions and table as the reference's (trash rows that
several retired slots write are compared as "one of the writes", since
neither side defines which lands); the sizing helpers give the same
numbers.  On the stablelm-3b smoke config with f32 params carried
across, the paged engine gives the same greedy tokens as the port's
contiguous engine and as the reference's paged engine, with the same
block counters, across refills and EOS waves; a small pool makes the
queue wait in FIFO order; an unservable request raises before any block
is taken; and through ``Server`` + the bio controller with a pinned
clock, admissions and outputs are the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_full  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.core import AdmissionController as JController  # noqa: E402
from repro.core import DecayingThreshold as JThreshold  # noqa: E402
from repro.core import EnergyMeter as JMeter  # noqa: E402
from repro.core import EnergyModel as JEnergyModel  # noqa: E402
from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import adapters as jadapters  # noqa: E402
from repro.serving import api as japi  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro_torch.configs import get_config as tget_full  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyMeter as TMeter  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import adapters as tadapters  # noqa: E402
from repro_torch.serving import api as tapi  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402

TOL = 1e-5
ARCH = "stablelm-3b"
BS = 8

# (B, H, K, hd, bs, mb, window, lengths: valid rows per slot, 0 = empty)
PAGED = {
    "shuffled_mha": (3, 4, 4, 32, 8, 4, 0, [32, 17, 9]),
    "window_gqa": (2, 8, 2, 16, 4, 6, 7, [24, 13]),
    "ragged_partial_table": (3, 4, 2, 32, 8, 4, 0, [5, 27, 0]),
    "gqa_hd80": (2, 8, 2, 80, 16, 3, 0, [40, 48]),
}


def _pool_case(B, H, K, hd, bs, mb, lengths, seed=0):
    """q, a pool with shuffled blocks (trash block 0 filled with 1e3),
    a table whose entries past each slot's mapped blocks are trash, and
    a valid prefix of ``lengths[b]`` rows per slot."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * mb
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    kp[0] = vp[0] = 1e3
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    table = np.zeros((B, mb), np.int32)
    kv_pos = np.full((B, mb * bs), -1, np.int32)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        table[b, :used] = perm[b * mb:b * mb + used]
        kv_pos[b, :n] = np.arange(n)
    cur = np.maximum(np.asarray(lengths, np.int32) - 1, 0)
    return q, kp, vp, table, kv_pos, cur


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_gather_block_views_matches_jax_and_raises_as_it():
    q, kp, vp, table, kv_pos, cur = _pool_case(3, 4, 2, 16, 4, 5,
                                               [20, 7, 0])
    for n_ctx in (8, 20):
        jk, jv = jda.gather_block_views(jnp.asarray(kp), jnp.asarray(vp),
                                        jnp.asarray(table), n_ctx)
        tk, tv = tda.gather_block_views(*_t(kp, vp, table), n_ctx)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for n_ctx, msg in ((6, "not a multiple"), (24, "maps only")):
        with pytest.raises(ValueError, match=msg):
            jda.gather_block_views(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(table), n_ctx)
        with pytest.raises(ValueError, match=msg):
            tda.gather_block_views(*_t(kp, vp, table), n_ctx)


@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_plain_matches_tpu_kernel_and_ref(case):
    B, H, K, hd, bs, mb, window, lengths = PAGED[case]
    q, kp, vp, table, kv_pos, cur = _pool_case(B, H, K, hd, bs, mb, lengths)
    tq, tkp, tvp, ttb, tkv, tcur = _t(q, kp, vp, table, kv_pos, cur)
    got = tda.paged_decode_attention_plain(tq, tkp, tvp, ttb, tkv, tcur,
                                           window=window)
    assert got.shape == (B, H, hd) and got.dtype == torch.float32
    rows = np.asarray(lengths) > 0                  # skip an empty slot
    jargs = [jnp.asarray(x) for x in (q, kp, vp, table, kv_pos, cur)]
    for want in (jda.paged_decode_attention(*jargs, window=window,
                                            interpret=True),
                 jops.paged_decode_attention(*jargs, window=window,
                                             impl="ref")):
        np.testing.assert_allclose(got.numpy()[rows],
                                   np.asarray(want)[rows], rtol=TOL,
                                   atol=TOL)
    for impl in ("auto", "ref"):
        assert torch.equal(ops.paged_decode_attention(
            tq, tkp, tvp, ttb, tkv, tcur, window=window, impl=impl), got)
    # the model's shim: the einsum path over the gathered view
    o = tattn.paged_decode_attend(
        tq[:, None], tattn.KVCache(k=tkp, v=tvp, pos=tkv), ttb,
        pos=tcur.long(), window=window)[:, 0]
    np.testing.assert_allclose(o.numpy()[rows], got.numpy()[rows],
                               rtol=TOL, atol=TOL)


def test_paged_cuda_and_shim_refuse_cpu_tensors():
    q, kp, vp, table, kv_pos, cur = _t(*_pool_case(2, 4, 2, 16, 4, 2,
                                                   [5, 8]))
    for impl in ("cuda", "shim"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.paged_decode_attention(q, kp, vp, table, kv_pos, cur,
                                       impl=impl)
    with pytest.raises(ValueError, match="impl"):
        ops.paged_decode_attention(q, kp, vp, table, kv_pos, cur,
                                   impl="pallas")
    with pytest.raises(ValueError, match="impl"):          # paged only
        ops.decode_attention(q, kp, vp, kv_pos, cur, impl="shim")
    for fn in (tda.paged_decode_attention_cuda,
               tda.paged_decode_attention_shim):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(q, kp, vp, table, kv_pos, cur)


def test_paged_cache_write_matches_jax():
    """Slots 0 and 1 are live; slots 2 and 3 are retired (all-trash
    table rows) at positions that share a trash row; slot 4's position
    lies past the logical extent, whose pos entry must not be written."""
    B, K, hd, bs, mb = 5, 2, 16, 4, 3
    rng = np.random.default_rng(1)
    NB = 1 + 2 * mb
    kp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    pos_arr = np.full((B, mb * bs), -1, np.int32)
    table = np.zeros((B, mb), np.int32)
    table[0] = [1, 2, 3]
    table[1] = [4, 5, 6]
    table[4] = [6, 5, 4]
    posv = np.array([5, 11, 6, 2, 13], np.int32)       # 13 >= C = 12
    kn = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    vn = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    jc = jattn.paged_cache_write(
        jattn.KVCache(k=jnp.asarray(kp), v=jnp.asarray(vp),
                      pos=jnp.asarray(pos_arr),
                      length=jnp.zeros((), jnp.int32)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(posv),
        jnp.asarray(table), bs)
    tc = tattn.KVCache(*_t(kp, vp, pos_arr))
    out = tattn.paged_cache_write(tc, *_t(kn, vn), torch.from_numpy(posv),
                                  torch.from_numpy(table), bs)
    assert out is tc                                     # in place
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert (tc.pos.numpy()[4] == -1).all()               # pos >= C dropped
    np.testing.assert_array_equal(tc.k.numpy()[1:], np.asarray(jc.k)[1:])
    np.testing.assert_array_equal(tc.v.numpy()[1:], np.asarray(jc.v)[1:])
    # the trash rows: the untouched ones as they were, the shared row
    # (slots 2 and 3 at offset 2) holds one of the two writes
    jk0, tk0 = np.asarray(jc.k)[0], tc.k.numpy()[0]
    np.testing.assert_array_equal(np.delete(tk0, 2, 0), np.delete(jk0, 2, 0))
    assert any((tk0[2] == kn[s, 0]).all() for s in (2, 3))
    # a scalar position writes every slot there
    tattn.paged_cache_write(tc, *_t(kn, vn), 3, torch.from_numpy(table), bs)
    assert (tc.pos.numpy()[:, 3] == 3).all()


def test_paged_slot_write_matches_jax():
    """Two prefilled rows into slots 2 and 0 of a 3-slot pool; the
    reference's bucket padding row (slot index B, table entries NB) is
    dropped on both sides; table tails are trash duplicates."""
    jcfg = jget(ARCH).replace(dtype="float32", kv_block_size=BS)
    tcfg = tget(ARCH).replace(dtype="float32", kv_block_size=BS)
    B, max_seq, npb = 3, 32, 2
    jpool = jtfm.init_cache(jcfg, B, max_seq, jnp.float32)
    NB = jpool.layers.kv.k.shape[1]
    rng = np.random.default_rng(2)
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    rk = rng.standard_normal((L, 3, 16, K, hd)).astype(np.float32)
    rv = rng.standard_normal((L, 3, 16, K, hd)).astype(np.float32)
    rpos = np.tile(np.where(np.arange(16) < 11, np.arange(16), -1),
                   (L, 3, 1)).astype(np.int32)
    slot_idx = np.array([2, 0, B], np.int32)
    table_rows = np.array([[7, 3, 5, 0], [1, 9, 0, 0], [NB, NB, NB, NB]],
                          np.int32)
    jrows = jpool._replace(layers=jpool.layers._replace(
        kv=jattn.KVCache(k=jnp.asarray(rk), v=jnp.asarray(rv),
                         pos=jnp.asarray(rpos),
                         length=jnp.zeros((L,), jnp.int32))),
        block_table=None)
    jout = jcont.paged_slot_write(jpool, jrows, jnp.asarray(slot_idx),
                                  jnp.asarray(table_rows), block_size=BS,
                                  n_pref_blocks=npb)
    tpool = ttfm.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    trows = ttfm.Cache(*_t(rk, rv, rpos))
    tcont.paged_slot_write(tpool, trows, slot_idx, table_rows,
                           block_size=BS, n_pref_blocks=npb)
    jkv = jout.layers.kv
    for got, want in ((tpool.k, jkv.k), (tpool.v, jkv.v),
                      (tpool.pos, jkv.pos),
                      (tpool.block_table, jout.block_table)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tpool.pos[0, 2, 11:].eq(-1).all()
    with pytest.raises(ValueError, match="repeated pool block"):
        tcont.paged_slot_write(tpool, trows, slot_idx,
                               np.array([[7, 7, 0, 0], [1, 9, 0, 0],
                                         [NB] * 4], np.int32),
                               block_size=BS, n_pref_blocks=npb)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("bs,nb", [(0, 0), (8, 0), (16, 13)])
def test_sizing_helpers_match_jax(full, bs, nb):
    jcfg = (jget_full if full else jget)(ARCH).replace(kv_block_size=bs,
                                                       kv_pool_blocks=nb)
    tcfg = (tget_full if full else tget)(ARCH).replace(kv_block_size=bs,
                                                       kv_pool_blocks=nb)
    for slots, max_seq in ((8, 128), (3, 40)):
        assert tcont.pool_hbm_bytes(tcfg, slots, max_seq) == \
            jcont.pool_hbm_bytes(jcfg, slots, max_seq)
        if bs:
            assert ttfm.paged_geometry(tcfg, slots, max_seq) == \
                jtfm.paged_geometry(jcfg, slots, max_seq)
    for plen, new, max_seq, b in ((16, 16, 128, 16), (8, 1, 64, 8),
                                  (40, 4, 128, 8), (120, 30, 128, 16)):
        assert tcont.blocks_for_request(plen, new, max_seq, b) == \
            jcont.blocks_for_request(plen, new, max_seq, b)
    assert tcont.blocks_for_request(16, 16, 128, 16) == 2


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

SLOTS, MAX_SEQ = 3, 40          # 5 blocks of 8: the paged extent is 40


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


def _requests(mod, vocab, n=9, seed=0, eos=None, max_new=None):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(k)).astype(np.int32)
               for k in rng.integers(3, 9, size=n)]
    eos = eos or {}
    return [mod.GenRequest(rid=i, prompt=prompts[i],
                           max_new=(max_new or 4 + i % 4),
                           eos_id=eos.get(i)) for i in range(n)]


def _engine(pair, side, *, sync_every=4, max_seq=MAX_SEQ, **paged):
    jcfg, params, tcfg, model = pair
    if side == "jax":
        return jcont.ContinuousBatchingEngine(
            jcfg.replace(**paged), params, n_slots=SLOTS, max_seq=max_seq,
            sync_every=sync_every)
    return tcont.ContinuousBatchingEngine(
        tcfg.replace(**paged), model, n_slots=SLOTS, max_seq=max_seq,
        sync_every=sync_every, device="cpu")


BLOCK_KEYS = ("blocks_allocated", "blocks_freed", "peak_blocks_in_use",
              "prefill_calls", "decode_steps", "occupied_slot_steps",
              "free_blocks", "pool_blocks", "kv_block_size", "mode")


@pytest.mark.parametrize("wave", ["refills", "eos_waves"])
def test_paged_engine_tokens_match_contiguous_and_jax(pair, wave):
    """Dynamic prompt lengths (no fixed ``prompt_len``), 9 requests over
    3 slots; ``eos_waves`` adds an EOS straight out of prefill and one
    mid-decode, both taken from a probe run."""
    vocab = pair[0].vocab
    eos = None
    if wave == "eos_waves":
        probe = _requests(tcont, vocab)
        _engine(pair, "torch").serve(probe)
        g4 = probe[4].generated          # a token new at its place > 0
        mid = next(t for j, t in enumerate(g4) if j and t not in g4[:j])
        eos = {0: probe[0].generated[0], 4: mid}
    runs = {}
    for side, mod, kw in (("torch", tcont, {}),
                          ("torch", tcont, dict(kv_block_size=BS)),
                          ("jax", jcont, dict(kv_block_size=BS))):
        reqs = _requests(mod, vocab, eos=eos)
        stats = _engine(pair, side, **kw).serve(reqs)
        runs[(side, bool(kw))] = ([r.generated for r in reqs], stats)
    toks, ts = runs[("torch", True)]
    assert toks == runs[("torch", False)][0]           # paged == contiguous
    assert toks == runs[("jax", True)][0]              # == the reference
    js = runs[("jax", True)][1]
    for key in BLOCK_KEYS:
        assert ts[key] == js[key], key
    assert ts["mode"] == "paged" and ts["prefill_calls"] >= 3
    assert ts["blocks_allocated"] == ts["blocks_freed"] > 0
    if eos:                          # each stops at its EOS's first place
        assert len(toks[0]) == 1
        assert len(toks[4]) == g4.index(mid) + 1 > 1


def test_paged_pool_exhaustion_waits_fifo(pair):
    """3 allocatable blocks and 2-block budgets: one request at a time,
    seated in queue order, nothing dropped, tokens as the contiguous
    engine's; every block is free or owned once after every window."""
    vocab = pair[0].vocab
    rc = _requests(tcont, vocab, n=5, seed=3)
    _engine(pair, "torch", sync_every=2).serve(rc, prompt_len=8)
    eng = _engine(pair, "torch", sync_every=2, kv_block_size=BS,
                  kv_pool_blocks=4)
    sess = eng.start_session(8)
    rp = _requests(tcont, vocab, n=5, seed=3)
    for r in rp:
        sess.push(r)
    order = []
    while not sess.idle:
        sess.advance()
        assert sess.n_active <= 1
        order += [r.rid for r in sess.slots if r is not None
                  and r.rid not in order]
        owned = [b for bl in sess._slot_blocks.values() for b in bl]
        assert len(owned) == len(set(owned)) and 0 not in owned
        assert sorted(owned + sess._free_blocks) == [1, 2, 3]
    assert order == [0, 1, 2, 3, 4]                          # FIFO
    assert all(r.done for r in rp)
    assert [r.generated for r in rp] == [r.generated for r in rc]
    assert sess.blocks_allocated == sess.blocks_freed == 10
    assert sess.peak_blocks_in_use == 2


def test_paged_unservable_request_raises_and_leaves_state_clean(pair):
    eng = _engine(pair, "torch", sync_every=2, max_seq=64,
                  kv_block_size=BS, kv_pool_blocks=4)       # 3 allocatable
    sess = eng.start_session(8)
    rng = np.random.default_rng(1)
    ok = tcont.GenRequest(rid=0, prompt=rng.integers(0, 50, 8), max_new=4)
    too_big = tcont.GenRequest(rid=1, prompt=rng.integers(0, 50, 8),
                               max_new=60)
    sess.push(ok)
    sess.push(too_big)
    with pytest.raises(ValueError, match="never be served"):
        sess.advance()
    assert len(sess._free_blocks) == 3 and sess._slot_blocks == {}
    assert sess.n_queued == 2 and sess.blocks_allocated == 0


def test_paged_long_prompt_does_not_inflate_earlier_budget(pair):
    """Co-padding a short request to a long prompt's bucket would cost
    9 blocks each (18 > 12): the wave splits instead of raising."""
    eng = _engine(pair, "torch", sync_every=2, max_seq=128,
                  kv_block_size=BS, kv_pool_blocks=13)
    sess = eng.start_session(None)
    rng = np.random.default_rng(0)
    short = tcont.GenRequest(rid=0, prompt=rng.integers(0, 50, 8),
                             max_new=4)
    long_ = tcont.GenRequest(rid=1, prompt=rng.integers(0, 50, 40),
                             max_new=4)
    sess.push(short)
    sess.push(long_)
    while not sess.idle:
        sess.advance()
    assert short.done and long_.done
    assert len(short.generated) == len(long_.generated) == 4
    assert sess.blocks_allocated == sess.blocks_freed == 2 + 9
    assert len(sess._free_blocks) == 12 and sess.prefill_calls == 2


class _Clock:
    """A wall clock for the adapters: every window takes 2 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.001
        return self.t


def test_paged_server_admissions_and_outputs_match_jax(pair, monkeypatch):
    monkeypatch.setattr(jadapters, "time", _Clock())
    monkeypatch.setattr(tadapters, "time", _Clock())
    jem = JEnergyModel()
    tem = TEnergyModel(peak_flops=jem.peak_flops, hbm_bw=jem.hbm_bw,
                       link_bw=jem.ici_bw, p_active=jem.p_active,
                       p_idle=jem.p_idle)
    n = 20
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, pair[0].vocab, size=(n, 8)).astype(np.int32)
    hints = rng.uniform(0, 1, size=n)

    def run(api, adapters, engine, ctrl, em):
        server = api.Server(adapters.ContinuousEngineAdapter(engine),
                            api.ServerConfig(path="continuous-decode",
                                             energy_model=em),
                            middleware=[api.AdmissionMiddleware(ctrl)])
        server.serve([api.InferRequest(
            rid=i, arrival_s=0.001 * i, payload=prompts[i], kind="generate",
            max_new=4 + i % 5, entropy_hint=float(hints[i]))
            for i in range(n)])
        return server

    paged = dict(kv_block_size=BS, kv_pool_blocks=6)   # 2 slots' worth
    js = run(japi, jadapters, _engine(pair, "jax", **paged),
             JController(threshold=JThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=JMeter(model=jem)), jem)
    ts = run(tapi, tadapters, _engine(pair, "torch", **paged),
             TController(threshold=TThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=TMeter(model=tem)), tem)

    def by_rid(server):
        return sorted((r.rid, r.path, r.admitted, r.output, r.t_finish)
                      for r in server.responses)

    assert by_rid(ts) == by_rid(js)
    assert 0.0 < ts.summary()["admission_rate"] < 1.0
    last = [r.telemetry for r in ts.responses if "blocks_freed" in
            r.telemetry][-1]
    assert last["mode"] == "paged" and last["pool_blocks"] == 6


def test_paged_misconfigurations_raise(pair):
    tcfg, model = pair[2], pair[3]
    with pytest.raises(ValueError, match="kv_block_size"):
        tcfg.replace(kv_pool_blocks=8)
    with pytest.raises(ValueError, match="kv_block_size"):
        ttfm.init_cache(tcfg, 2, 32, device="cpu", layout="paged")
    windowed = tcfg.replace(kv_block_size=BS, window=16)   # local_attn
    with pytest.raises(ValueError, match="paged KV pool"):
        ttfm.init_cache(windowed, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="paged KV pool"):
        tcont.ContinuousBatchingEngine(windowed, model, device="cpu")
    pool = ttfm.init_cache(tcfg.replace(kv_block_size=BS), 2, 32,
                           device="cpu")
    assert pool.k.shape[1:3] == (9, BS) and pool.n_slots == 2
    assert tuple(pool.block_table.shape) == (2, 4)
    with pytest.raises(ValueError, match="paged pool"):
        model.prefill(np.zeros((2, 8), np.int32), pool)
    with pytest.raises(ValueError, match="contiguous"):
        model.decode_chunk(np.zeros((2, 2), np.int32), pool, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tcont.ContinuousBatchingEngine(
            tcfg.replace(kv_block_size=BS, draft_layers=1), model,
            draft_depth=2, device="cpu")


def test_launcher_paged_smoke_on_cpu(tmp_path):
    """``--mode generate --smoke --kv-block-size 8 --kv-pool-blocks 9``
    end to end on the CPU: every request answered once, the paged stats
    in the summary, every block given back."""
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--smoke",
         "--kv-block-size", "8", "--kv-pool-blocks", "9", "--requests",
         "6", "--new-tokens", "3", "--slots", "4", "--runs", str(tmp_path)])
    summary, server = tserve.serve_generate(args)
    assert sorted(r.rid for r in server.responses) == list(range(6))
    assert summary["mode"] == "paged" and summary["kv_block_size"] == 8
    assert summary["pool_blocks"] == 9
    assert summary["blocks_allocated"] == summary["blocks_freed"] > 0
    assert summary["peak_blocks_in_use"] <= 8
    assert summary["kv_pool_bytes"] == tcont.pool_hbm_bytes(
        tserve.generate_config(args), 4, tserve.GEN_MAX_SEQ)["total_bytes"]
