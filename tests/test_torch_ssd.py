"""The port's Mamba-2 SSD path against the reference, on the CPU.

The SSD scan's plain versions (the per-token recurrence and the chunked
algorithm) against ``repro.kernels.ref.ssd_scan``, the Pallas kernel in
interpret mode and ``repro.models.ssd.ssd_chunked`` (y and the last
state, from a nonzero initial state); the SSD block's prefill and
single steps; the mamba2-780m smoke config (2 layers, d 128, 8 heads of
32, state 16, chunk 8) in f32 with the reference's weights carried
across by ``lm_from_numpy``: logits, caches and greedy tokens; the
continuous engine's tokens and window counters, and ``Server`` + the
bio controller's decisions with one ``EnergyModel`` on both sides and
a pinned clock; the pool's byte count.  Inputs come from numpy with a
seed.  Tolerances: 2e-4 for the scan against the reference and the
Pallas kernel (``tests/test_kernels.py``'s) and for logits
(``tests/test_models.py``'s), 1e-4 for the chunked scan and the block,
whose sums are short.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssdk  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import adapters as jadapters  # noqa: E402
from repro.serving import api as japi  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_config as tget_full  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.core import AdmissionController as TController  # noqa: E402
from repro_torch.core import DecayingThreshold as TThreshold  # noqa: E402
from repro_torch.core import EnergyMeter as TMeter  # noqa: E402
from repro_torch.core import EnergyModel as TEnergyModel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssd as tssd_model  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import adapters as tadapters  # noqa: E402
from repro_torch.serving import api as tapi  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

ARCH = "mamba2-780m"
SCAN_TOL = 2e-4
STATE_TOL = 1e-4
LOGITS_TOL = 2e-4
SLOTS, MAX_SEQ = 3, 48
MAX_NEW = [5, 9, 3, 12, 6, 2, 8]
JEM = JEnergyModel()
TEM = TEnergyModel(peak_flops=JEM.peak_flops, hbm_bw=JEM.hbm_bw,
                   link_bw=JEM.ici_bw, p_active=JEM.p_active,
                   p_idle=JEM.p_idle)


def _scan_inputs(B, S, H, hd, N, seed=0):
    """x, dt (softplus'd), A (< 0), Bm, Cm and a nonzero h0, f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, hd, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# tests/test_kernels.py:338-343, the ragged tail included
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 24, 3, 8, 16, 8),
    (1, 40, 2, 16, 8, 16),
    (2, 33, 4, 8, 8, 8),
    (1, 16, 1, 32, 32, 16),
])
def test_ssd_scan_plain_matches_ref_and_pallas(B, S, H, hd, N, chunk):
    x, dt, A, Bm, Cm, _ = _scan_inputs(B, S, H, hd, N, seed=B * S + H)
    y_ref = jref.ssd_scan(*_j(x, dt, A, Bm, Cm))
    y_pallas = jssdk.ssd_scan(*_j(x, dt, A, Bm, Cm), chunk=chunk,
                              interpret=True)
    y_plain = tssd.ssd_scan_plain(*_t(x, dt, A, Bm, Cm))
    y_ops = tops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk, impl="ref")
    assert y_plain.shape == (B, S, H, hd) and y_plain.dtype == torch.float32
    for want in (y_ref, y_pallas):
        _close(y_plain, want, SCAN_TOL)
        _close(y_ops, want, SCAN_TOL)
    # "auto" on a CPU tensor is the plain version
    assert torch.equal(tops.ssd_scan(*_t(x, dt, A, Bm, Cm)), y_plain)


@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 24, 3, 8, 16, 8),
    (2, 33, 4, 8, 8, 8),           # ragged tail
    (1, 40, 2, 16, 8, 16),
    (1, 20, 2, 8, 8, 64),          # one chunk longer than the sequence
])
def test_ssd_chunked_plain_with_state_matches_jax(B, S, H, hd, N, chunk):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(B, S, H, hd, N, seed=S)
    y_j, h_j = jssd.ssd_chunked(*_j(x, dt, A, Bm, Cm, h0), chunk)
    y_t, h_t = tssd.ssd_chunked_plain(*_t(x, dt, A, Bm, Cm, h0), chunk)
    _close(y_t, y_j, STATE_TOL)
    _close(h_t, h_j, STATE_TOL)
    for impl in ("ref", "auto"):
        y_o, h_o = tops.ssd_chunked(*_t(x, dt, A, Bm, Cm, h0), chunk=chunk,
                                    impl=impl)
        assert torch.equal(y_o, y_t) and torch.equal(h_o, h_t)
    # from a zero state the chunked algorithm is the scan
    zero = np.zeros_like(h0)
    y_0, _ = tssd.ssd_chunked_plain(*_t(x, dt, A, Bm, Cm, zero), chunk)
    _close(y_0, jref.ssd_scan(*_j(x, dt, A, Bm, Cm)), SCAN_TOL)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_ssd_block_prefill_then_steps_match_jax(impl):
    """Prefill of 10 tokens (chunk 4, ragged) into a zero state, then 3
    single steps: outputs and the state (conv tail, SSD state) within
    1e-4 after each call; the full-sequence mode from no state too."""
    d, kw = 32, dict(expand=2, headdim=16, d_state=8)
    p_j = jssd.ssd_params(jax.random.PRNGKey(3), d, conv_width=4, **kw)
    p_t = tssd_model.SSDParams(d, conv_width=4, **kw)
    convert.load_state(p_t, convert.flatten_tree(
        jax.tree.map(np.asarray, p_j)))
    x = np.random.default_rng(5).standard_normal((2, 13, d)).astype(
        np.float32)
    st_j = jssd.init_ssd_state(2, d, conv_width=4, **kw)
    st_t = tssd_model.init_ssd_state(2, d, conv_width=4, device="cpu", **kw)
    y_j, st_j = jssd.ssd_block(p_j, jnp.asarray(x[:, :10]), st_j, chunk=4,
                               **kw)
    y_t = tssd_model.ssd_block(p_t, torch.from_numpy(x[:, :10]), st_t,
                               chunk=4, impl=impl)
    _close(y_t, y_j, STATE_TOL)
    for t in range(10, 13):
        _close(st_t.conv, st_j.conv, STATE_TOL)
        _close(st_t.h, st_j.h, STATE_TOL)
        y_j, st_j = jssd.ssd_block(p_j, jnp.asarray(x[:, t:t + 1]), st_j,
                                   chunk=4, single_step=True, **kw)
        y_t = tssd_model.ssd_block(p_t, torch.from_numpy(x[:, t:t + 1]),
                                   st_t, chunk=4, single_step=True,
                                   impl=impl)
        _close(y_t, y_j, STATE_TOL)
    _close(st_t.h, st_j.h, STATE_TOL)
    zero = jssd.init_ssd_state(2, d, conv_width=4, **kw)
    y_j, _ = jssd.ssd_block(p_j, jnp.asarray(x), zero, chunk=4, **kw)
    _close(tssd_model.ssd_block(p_t, torch.from_numpy(x), None, chunk=4,
                                impl=impl), y_j, STATE_TOL)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jtfm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, params, tcfg, model


def _tokens(B, S, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - b.float().numpy()).max())


def test_ssd_leaves_carry_across(pair):
    """``lm_from_numpy`` carries every SSD leaf, the f32 ones as f32."""
    _, params, _, model = pair
    mix = model.layers[1].mix
    for name in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                 "out_proj"):
        np.testing.assert_array_equal(
            getattr(mix, name).numpy(),
            np.asarray(params["layers"]["mix"][name][1]))
    np.testing.assert_array_equal(
        mix.norm.scale.numpy(),
        np.asarray(params["layers"]["mix"]["norm"]["scale"][1]))
    assert mix.A_log.dtype == torch.float32
    assert not hasattr(model.layers[0], "norm2") and model.layers[0].mlp is None
    bf16 = convert.lm_from_numpy(tget(ARCH), jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert bf16.layers[0].mix.in_proj.dtype == torch.bfloat16
    assert bf16.layers[0].mix.A_log.dtype == torch.float32


@pytest.mark.parametrize("impl", ["xla", "ref"])
def test_lm_forward_prefill_decode_match_jax(pair, impl):
    """19 tokens: more than two of the smoke config's 8-token chunks."""
    jcfg, params, _, model = pair
    model.attn_impl = impl
    toks = _tokens(2, 21, jcfg.vocab)
    f1, _ = jtfm.forward(jcfg, params, jnp.asarray(toks[:, :19]))
    f2, aux = model.forward(toks[:, :19])
    assert f2.shape == (2, 19, jcfg.vocab) and float(aux) == 0.0
    assert _err(f1, f2) < LOGITS_TOL
    c1 = jtfm.init_cache(jcfg, 2, 32)
    c2 = ttfm.init_cache(model.cfg, 2, 32, device="cpu")
    assert c2.h.dtype == torch.float32 and c2.k is None
    p1, c1 = jtfm.prefill(jcfg, params, jnp.asarray(toks[:, :19]), c1)
    p2, c2 = model.prefill(toks[:, :19], c2)
    assert p2.shape == (2, 1, jcfg.vocab) and _err(p1, p2) < LOGITS_TOL
    assert _err(c1.layers.rec.h, c2.h) < STATE_TOL
    assert _err(c1.layers.rec.conv, c2.conv) < STATE_TOL
    # lockstep (scalar pos), then continuous ([B] pos)
    d1, c1 = jtfm.decode_step(jcfg, params, jnp.asarray(toks[:, 19:20]), c1,
                              19)
    d2, c2 = model.decode_step(toks[:, 19:20], c2, 19)
    assert _err(d1, d2) < LOGITS_TOL
    pos = np.array([20, 20], np.int32)
    d1, c1 = jtfm.decode_step(jcfg, params, jnp.asarray(toks[:, 20:21]), c1,
                              jnp.asarray(pos))
    d2, c2 = model.decode_step(toks[:, 20:21], c2, torch.from_numpy(pos))
    assert _err(d1, d2) < LOGITS_TOL
    assert _err(c1.layers.rec.h, c2.h) < STATE_TOL
    assert int(c2.length) == 21
    model.attn_impl = "auto"


def test_auto_on_cpu_is_bitwise_the_model_path(pair):
    """``attn_impl="auto"`` on a CPU tensor takes the model's own
    chunked scan, bitwise equal to ``"xla"``."""
    jcfg, _, _, model = pair
    toks = _tokens(2, 12, jcfg.vocab, seed=3)
    out = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        c = ttfm.init_cache(model.cfg, 2, 16, device="cpu")
        lp, c = model.prefill(toks[:, :11], c)
        ld, _ = model.decode_step(toks[:, 11:12], c, torch.tensor([11, 11]))
        out[impl] = (model.forward(toks)[0], lp, ld, c.h)
    for a, b in zip(out["auto"], out["xla"]):
        assert torch.equal(a, b)
    model.attn_impl = "auto"


def test_greedy_tokens_match_jax(pair):
    jcfg, params, _, model = pair
    prompts = _tokens(3, 11, jcfg.vocab, seed=11)
    want = jengine.GenerationEngine(jcfg, params, max_seq=32).generate(
        prompts, 10)
    got = tengine.GenerationEngine(model.cfg, model, max_seq=32,
                                   device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(got, want)


def _prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 12, size=len(MAX_NEW))]


def _requests(mod, prompts, eos=None):
    eos = eos or {}
    return [mod.GenRequest(rid=i, prompt=p, max_new=m, eos_id=eos.get(i))
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


def _engines(pair, **kw):
    jcfg, params, tcfg, model = pair
    je = jcont.ContinuousBatchingEngine(jcfg, params, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, **kw)
    te = tcont.ContinuousBatchingEngine(tcfg, model, n_slots=SLOTS,
                                        max_seq=MAX_SEQ, device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("sync_every", [1, 4])
def test_engine_tokens_and_counters_match_jax(pair, sync_every):
    """7 requests over 3 slots (slots reused, so a seated slot's state
    must replace its previous occupant's), mixed budgets and one EOS."""
    jcfg = pair[0]
    prompts = _prompts(jcfg.vocab)
    je, te = _engines(pair, sync_every=sync_every)
    probe = _requests(jcont, prompts)
    je.serve(probe)
    eos = {1: probe[1].generated[3]}
    jr, tr = _requests(jcont, prompts, eos), _requests(tcont, prompts, eos)
    js, ts = je.serve(jr), te.serve(tr)
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, b.rid
        assert b.done and b.admitted
    assert len(tr[1].generated) < MAX_NEW[1]          # stopped on its EOS
    for key in ("decode_steps", "occupied_slot_steps", "host_syncs",
                "prefill_calls", "tokens_generated", "n_admitted"):
        assert ts[key] == js[key], key
    assert ts["prefill_calls"] >= 2                    # slots were reused


def test_slot_write_replaces_the_state_whole(pair):
    tcfg = pair[2]
    pool = ttfm.init_cache(tcfg, 3, 16, device="cpu")
    pool.h.fill_(7.0)
    pool.conv.fill_(7.0)
    rows = ttfm.init_cache(tcfg, 3, 16, device="cpu")
    rows.h[:, 0].fill_(1.0)
    rows.conv[:, 2].fill_(2.0)
    tcont.slot_write(pool, rows, np.array([2, 3, 0]))  # row 1 is padding
    assert pool.h[:, 2].eq(1).all() and pool.h[:, 0].eq(0).all()
    assert pool.conv[:, 0].eq(2).all() and pool.conv[:, 2].eq(0).all()
    assert pool.h[:, 1].eq(7).all() and pool.conv[:, 1].eq(7).all()
    with pytest.raises(ValueError, match="repeated"):
        tcont.slot_write(pool, rows, np.array([1, 1, 0]))
    kv = ttfm.init_cache(tget("stablelm-3b"), 3, 16, device="cpu")
    with pytest.raises(ValueError, match="do not mix"):
        tcont.slot_write(pool, kv, np.array([0, 1, 2]))


class _Clock:
    """A wall clock for the adapters: every window takes 2 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.001
        return self.t


def test_server_admissions_and_outputs_match_jax(pair, monkeypatch):
    jcfg, params, tcfg, model = pair
    monkeypatch.setattr(jadapters, "time", _Clock())
    monkeypatch.setattr(tadapters, "time", _Clock())
    n = 24
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab, size=(n, 8)).astype(np.int32)
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

    je, te = _engines(pair, sync_every=4)
    js = run(japi, jadapters, je,
             JController(threshold=JThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=JMeter(model=JEM)), JEM)
    ts = run(tapi, tadapters, te,
             TController(threshold=TThreshold(tau0=1.0, tau_inf=0.45, k=0.8),
                         meter=TMeter(model=TEM)), TEM)

    def by_rid(server):
        return sorted((r.rid, r.path, r.admitted, r.output, r.t_finish)
                      for r in server.responses)

    assert by_rid(ts) == by_rid(js)
    tsum, jsum = ts.summary(), js.summary()
    assert np.isnan(tsum.pop("accuracy")) and np.isnan(jsum.pop("accuracy"))
    assert tsum == jsum
    assert 0.0 < tsum["admission_rate"] < 1.0


@pytest.mark.parametrize("which,slots", [("published", 8), ("smoke", 3)])
def test_pool_hbm_bytes_match_jax(which, slots):
    jcfg = (jget_full if which == "published" else jget)(ARCH)
    tcfg = (tget_full if which == "published" else tget)(ARCH)
    want = jcont.pool_hbm_bytes(jcfg, slots, 128)
    assert tcont.pool_hbm_bytes(tcfg, slots, 128) == want
    if which == "published":
        assert want == {"kv_bytes": 619_315_204, "meta_bytes": 0,
                        "total_bytes": 619_315_204}


def test_cuda_impl_refuses_cpu_and_paged_refuses_ssd(pair):
    x, dt, A, Bm, Cm, h0 = _t(*_scan_inputs(1, 8, 2, 8, 8))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tops.ssd_scan(x, dt, A, Bm, Cm, impl="cuda")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tops.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=4, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.ssd_scan(x, dt, A, Bm, Cm, impl="pallas")
    tcfg, model = pair[2], pair[3]
    paged = tcfg.replace(kv_block_size=8)
    with pytest.raises(ValueError, match="paged KV pool"):
        ttfm.init_cache(tcfg, 2, 16, device="cpu", layout="paged")
    with pytest.raises(ValueError, match="paged KV pool"):
        tcont.ContinuousBatchingEngine(paged, model, device="cpu")
    with pytest.raises(ValueError, match="paged KV pool"):
        tcont.pool_hbm_bytes(paged, 2, 16)
    # speculation refuses an SSD stack with the reference's errors: no
    # draft prefix configured, then not a pure attention stack
    for draft_layers in (0, 1):
        with pytest.raises(ValueError) as want:
            jcont.ContinuousBatchingEngine(
                pair[0].replace(draft_layers=draft_layers), pair[1],
                n_slots=2, max_seq=16, draft_depth=2)
        with pytest.raises(ValueError) as got:
            tcont.ContinuousBatchingEngine(
                tcfg.replace(draft_layers=draft_layers), model, n_slots=2,
                max_seq=16, draft_depth=2, device="cpu")
        assert str(got.value) == str(want.value)
        assert ("draft_layers" if draft_layers == 0
                else "pure attention stack") in str(got.value)


def test_launcher_generate_mamba_smoke_on_cpu(tmp_path):
    args = tserve.parser().parse_args(
        ["--device", "cpu", "--mode", "generate", "--arch", ARCH, "--smoke",
         "--requests", "6", "--new-tokens", "3", "--slots", "2", "--runs",
         str(tmp_path)])
    summary, server = tserve.serve_generate(args)
    vocab = tget(ARCH).vocab
    resp = sorted(server.responses, key=lambda r: r.rid)
    assert [r.rid for r in resp] == list(range(6))
    for r in resp:
        if r.admitted:
            assert 1 <= len(r.output) <= 3
            assert all(0 <= t < vocab for t in r.output)
    assert summary["arch"] == ARCH and summary["n_layers"] == 2
    assert summary["kv_pool_bytes"] == tcont.pool_hbm_bytes(
        tget(ARCH), 2, tserve.GEN_MAX_SEQ)["total_bytes"]
    assert summary["decode_steps"] > 0
