"""Moonlight-16B-A3B in the port (``configs/moonlight_16b_a3b.py``)
against its plain reference, ``perfbench/reference/moonlight.py``, on
the CPU at ``smoke_config()``'s size, on the benchmark's seeded weights
(``perfbench/lib/weights.py``) installed as the port's parameters.

- The model API: a prompt prefilled, then decoded token by token
  through the latent cache, at a scalar position and at per-slot ones;
  every position's logits against the reference's one full causal pass,
  f32 weights and cache: within 1e-4 (|logit| up to ~5; the absorbed
  decode sums in another order than the expanded pass: 6e-6 at most
  over six seeds).  A bf16 cache is not held to a logit tolerance here:
  at this size rounding a latent row flips a near-tied expert choice
  now and then (one seed in six read a logit 2.2 off), so the bf16
  path is held as the benchmark holds it, below.
- The engine: the benchmark's whole run at smoke size
  (``perfbench.lib.bench.run_cell``, f32 weights), its served greedy
  tokens scored by the reference: with an f32 cache every token the
  reference's own; with the bf16 latent cache the engine serves, under
  limits that rounding leaves room for (``ENGINE_LIMITS``).
- The router: the correction bias moves the choice and not the gates,
  the gates are renormalised before the 2.446 scale, the shared expert
  is added to every token, and at ``capacity_factor`` 11.0 the capacity
  is the whole group at every group size; the softmax router is the
  parent's rule, bit for bit.
- The layout: layer 0 dense, the others MoE; 15.96 B parameters; the
  reference's parameters are the port's, name for name and shape for
  shape; the reference imports neither JAX nor the port's kernels.
- The session's work counters against the shapes.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import bench, describe  # noqa: E402
from perfbench.lib import weights as wts  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.continuous import (  # noqa: E402
    ContinuousBatchingEngine, GenRequest)

ARCH = "moonlight-16b-a3b"
REF = describe.load({"reference": "reference/moonlight.py"})
SEED = 2 ** 33 + 11


def _model_block(cfg: ModelConfig) -> dict:
    keys = ("n_layers", "d_model", "n_heads", "kv_lora_rank", "qk_nope_dim",
            "qk_rope_dim", "v_head_dim", "vocab", "d_ff", "n_experts",
            "top_k", "d_ff_expert", "n_shared_experts", "first_dense_layers",
            "routed_scale", "rope_theta", "dtype")
    return {k: getattr(cfg, k) for k in keys}


def _seeded(cfg: ModelConfig, seed: int = SEED):
    """The port's LM on the CPU holding the benchmark's seeded weights,
    and the reference's reader of the same weights in f32."""
    m = _model_block(cfg)
    w = wts.make(REF, m, seed, "cpu")
    model = tfm.LM(cfg, device="meta")
    wts.install(model, w)
    return model.eval(), REF.dims(m), (lambda n: w[n].float())


SMOKE = get_smoke_config(ARCH).replace(dtype="float32")


@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["lockstep", "per-slot"])
def test_prefill_then_latent_decode_agrees_with_reference(per_slot):
    model, z, weight = _seeded(SMOKE)
    rng = np.random.default_rng(5)
    B, P, N = 2, 7, 9
    seqs = rng.integers(0, SMOKE.vocab, (B, P + N))
    cache = tfm.init_cache(SMOKE, B, 32, torch.float32, device="cpu")
    got = [model.prefill(torch.as_tensor(seqs[:, :P]), cache)[0][:, 0]]
    for j in range(P, P + N - 1):
        pos = torch.full((B,), j) if per_slot else j
        got.append(model.decode_step(torch.as_tensor(seqs[:, j:j + 1]),
                                     cache, pos)[0][:, 0])
    got = torch.stack(got, 1)                                # [B, N, V]
    at = torch.arange(P - 1, P + N - 1)
    for b in range(B):
        want = REF.logits(z, weight, torch.as_tensor(seqs[b]), at)
        assert (got[b] - want).abs().max() < 1e-4


# the engine's limits, over every request the window finished: with its
# cache in f32 the served tokens are the reference's own (every gap 0 on
# six seeds); with the bf16 latent cache it serves, rounding flips a near
# tie now and then and the flip carries on, so a single gap says little
# (up to 1.83 over 22 runs) and the mean is held, as the benchmark's cell
# holds it: the program's largest 0.0021 over 22 runs, the fp8 control's
# least 0.089 (perfbench/reference/control.py at this size)
ENGINE_LIMITS = {torch.float32: {"logit_gap": 1e-3, "length_errors": 0},
                 torch.bfloat16: {"mean_logit_gap": 0.02, "length_errors": 0}}


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-cache", "bf16-cache"])
def test_engine_run_agrees_with_reference(monkeypatch, cache_dtype):
    conf = json.loads((ROOT / "perfbench" / "tests" / "data"
                       / "smoke-moonlight.json").read_text())
    mix = json.loads((ROOT / "perfbench" / "tests" / "data"
                      / "smoke-backlog.json").read_text())
    mix["sample"] = 1000          # every finished request is compared

    class Clock:
        def read_j(self):
            return time.perf_counter() * 300.0

    def init_cache(self, batch, max_seq=None, *, layout="auto"):
        return tfm.init_cache(self.cfg, batch, max_seq or self.max_seq,
                              cache_dtype, device=self.device, layout=layout)
    monkeypatch.setattr(ContinuousBatchingEngine, "init_cache", init_cache)
    rec = bench.run_cell({"name": "smoke"}, conf, mix,
                         ENGINE_LIMITS[cache_dtype], seed=SEED, seconds=1.0,
                         trace=False, device="cpu", energy=Clock(),
                         t_start=time.perf_counter())
    assert rec["correct"], rec["checks"]
    assert rec["tokens_compared"] >= 40 and rec["failed"] == 0


def _router_case(score="sigmoid", scale=2.446, seed=0):
    g = torch.Generator().manual_seed(seed)
    router = torch.randn(16, 8, generator=g)
    x = torch.randn(1, 12, 16, generator=g)
    bias = torch.randn(8, generator=g)
    return router, x, bias


def _bias_moves_choice_not_gates():
    router, x, bias = _router_case()
    _, w0, idx0, *_ = moe.route(router, x, 3, 11.0, score="sigmoid",
                                scale=2.446)
    _, w1, idx1, *_ = moe.route(router, x, 3, 11.0, score="sigmoid",
                                bias=bias, scale=2.446)
    s = torch.sigmoid(x.float() @ router)
    assert not torch.equal(idx0, idx1)
    want = torch.topk(s + bias, 3).indices
    assert torch.equal(idx1, want)
    # the gates are the uncorrected scores of the chosen experts
    g = s.gather(-1, idx1)
    torch.testing.assert_close(w1, g / g.sum(-1, keepdim=True) * 2.446,
                               rtol=0, atol=1e-6)


def _renormalised_then_scaled():
    router, x, bias = _router_case(seed=1)
    _, w, *_ = moe.route(router, x, 3, 11.0, score="sigmoid", bias=bias,
                         scale=2.446)
    torch.testing.assert_close(w.sum(-1), torch.full(w.shape[:-1], 2.446),
                               rtol=0, atol=1e-6)
    _, w1, *_ = moe.route(router, x, 3, 11.0, score="sigmoid", bias=bias)
    torch.testing.assert_close(w, w1 * 2.446, rtol=0, atol=1e-6)


def _softmax_route_is_the_parents():
    """The softmax router's rule as it stood before the sigmoid one came
    beside it, bit for bit, on granite's smoke sizes."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    g = torch.Generator().manual_seed(3)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    x = torch.randn(2, 16, cfg.d_model, generator=g).bfloat16()
    gates, w, idx, pos, keep, C = moe.route(router, x, cfg.top_k, 1.25)
    want = torch.softmax(x.float() @ router, dim=-1)
    ws, iw = torch.sort(want, dim=-1, descending=True, stable=True)
    ws, iw = ws[..., :cfg.top_k], iw[..., :cfg.top_k]
    assert torch.equal(gates, want) and torch.equal(idx, iw)
    assert torch.equal(w, ws / (ws.sum(-1, keepdim=True) + 1e-9))


def _shared_expert_on_every_token():
    d, E, fe, fs = 16, 8, 12, 24
    p = moe.MoEParams(d, E, fe, d_ff_shared=fs, router_bias=True)
    p.reset_parameters(torch.Generator().manual_seed(2))
    plain = moe.MoEParams(d, E, fe)
    for n in ("router", "w_gate", "w_up", "w_down"):
        setattr(plain, n, getattr(p, n))
    x = torch.randn(2, 5, d, generator=torch.Generator().manual_seed(4))
    kw = dict(top_k=3, capacity_factor=11.0, need_aux=False, score="sigmoid",
              scale=2.446)
    y, _ = moe.moe_forward(p, x, **kw)
    y0, _ = moe.moe_forward(plain, x, **kw)     # the bias is zero at init
    shared = (torch.nn.functional.silu(x @ p.shared_gate)
              * (x @ p.shared_up)) @ p.shared_down
    torch.testing.assert_close(y - y0, shared, rtol=0, atol=1e-6)
    assert (shared.abs().amax(-1) > 0).all()


@pytest.mark.parametrize("case", [_bias_moves_choice_not_gates,
                                  _renormalised_then_scaled,
                                  _softmax_route_is_the_parents,
                                  _shared_expert_on_every_token],
                         ids=lambda f: f.__name__.strip("_"))
def test_router(case):
    case()


@pytest.mark.parametrize("g", [1, 16, 128, 256, 1024])
def test_capacity_is_the_group_at_11(g):
    cfg = get_config(ARCH)
    assert moe.capacity(g, cfg.top_k, cfg.n_experts,
                        cfg.capacity_factor) == g


def test_layer_zero_dense_the_rest_moe():
    cfg = get_config(ARCH)
    model = tfm.abstract_lm(cfg)
    assert model.layers[0].moe is None
    assert tuple(model.layers[0].mlp.w_gate.shape) == (2048, 11_264)
    for layer in model.layers[1:]:
        assert layer.mlp is None and layer.moe.shared
        assert tuple(layer.moe.w_gate.shape) == (64, 2048, 1408)
        assert tuple(layer.moe.shared_gate.shape) == (2048, 2816)
        assert layer.moe.router_bias.dtype == torch.float32
    assert [k for k in cfg.block_kinds] == ["mla"] * 27


def test_parameter_count():
    cfg = get_config(ARCH)
    assert abs(cfg.n_params() / 15.96e9 - 1) < 0.005
    model = tfm.abstract_lm(cfg)
    assert abs(sum(p.numel() for p in model.parameters())
               / cfg.n_params() - 1) < 1e-5
    # every routed expert is counted once, six a token
    per_expert = 3 * 2048 * 1408
    assert cfg.n_params() - cfg.n_active_params() == 26 * 58 * per_expert


@pytest.mark.parametrize("arch", [ARCH], ids=["full"])
def test_reference_layout_is_the_ports(arch):
    """The reference's parameters are the port's, name for name, shape
    for shape and dtype for dtype; its counts are the published ones."""
    cfg = get_config(arch)
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / f"{arch}.json").read_text())
    ref = describe.load(conf)
    m = conf["model"]
    own = {n: (tuple(p.shape), p.dtype)
           for n, p in tfm.abstract_lm(ModelConfig(**m)).named_parameters()}
    kinds = {n: k for n, _, k in ref.specs(m)}
    assert set(kinds) == set(own)
    for n, shape, kind in ref.specs(m):
        dt = torch.bfloat16 if kind in ("matrix", "embed") else torch.float32
        assert own[n] == (shape, dt), n
    assert ModelConfig(**m).replace(source=cfg.source) == cfg
    z = ref.dims(m)
    assert ref.cache_row_bytes(z) == 31_104
    assert abs(ref.matmul_params(z) / 2.58e9 - 1) < 0.005
    assert ref.attention_flops(z, 1) == 2 * 16 * (192 + 128) * 27
    # the catalog's keys sit at the file's top level, as published
    assert (conf["num_hidden_layers"], conf["hidden_size"],
            conf["kv_lora_rank"], conf["n_routed_experts"],
            conf["vocab_size"]) == (27, 2048, 512, 64, 163_840)
    assert conf["reduced"] == [] and conf["serving"]["max_seq"] == 2048


def test_reference_imports_neither_jax_nor_the_kernels():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from perfbench.lib import describe\n"
            "describe.load({'reference': 'reference/moonlight.py'})\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'repro_torch'))\n"
            "print(bad)\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_session_work_counters():
    """Refills count their padded rows' routing, windows every step's
    routing and every latent row of every slot."""
    cfg = get_smoke_config(ARCH)
    eng = ContinuousBatchingEngine(cfg, tfm.init_lm(cfg, 0, device="cpu"),
                                   n_slots=3, max_seq=40, sync_every=4,
                                   device="cpu")
    sess = eng.start_session()
    for rid, n in enumerate((5, 9, 6, 3)):
        sess.push(GenRequest(rid=rid, prompt=list(range(1, n + 1)),
                             max_new=6, eos_id=None))
    windows = 0
    while not sess.idle:
        sess.advance()
        windows += 1
    n_moe, E, k = 2, cfg.n_experts, cfg.top_k
    dec = sess.work["decode"]
    assert dec["moe_pairs"] == windows * 4 * n_moe * 3 * k
    assert dec["moe_rows"] == windows * 4 * n_moe * E * 3     # C = g = 3
    assert dec["latent_rows"] == windows * 4 * 3 * cfg.n_layers * 40
    pre = sess.work["prefill"]
    assert pre["latent_rows"] == 0 and pre["moe_pairs"] > 0
    assert pre["moe_rows"] == pre["moe_pairs"] // k * E      # dropless
    assert sess.prefill_calls >= 2


@pytest.mark.parametrize("arch,useful", [(ARCH, 6 / 64),
                                          ("granite-moe-3b-a800m", 8 / 40)])
def test_decode_step_work_at_the_cells(arch, useful):
    """A cell's decode step, at its configuration and slots: the share of
    the expert rows multiplied that a routed pair fills (about 9 % and
    20 %), and the latent rows scored."""
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / f"{arch}.json").read_text())
    slots = conf["serving"]["slots"]
    w = tfm.step_work(ModelConfig(**conf["model"]), slots, 1,
                      cache_rows=conf["serving"]["max_seq"])
    assert w["moe_pairs"] / w["moe_rows"] == pytest.approx(useful)
    mla = arch == ARCH
    assert w["latent_rows"] == (27 * slots * 2048 if mla else 0)
