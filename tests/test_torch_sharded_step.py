"""Sharded steps of the port on 8 gloo ranks (a 2 x 4 CPU mesh, "data"
x "model"), each held against the port's own single-device result.

One ``torch.multiprocessing`` spawn for the whole file runs every check
on every rank; rank 0 writes the numbers, and the tests read them.  The
three scenarios are the reference's (``tests/test_dryrun.py:46-137``),
with its bounds: the internlm2 smoke train step in f32 (loss within
1e-4, weights within 1e-3, at the full learning rate; since Adam's
first step moves a weight by about lr whatever its gradient, each
leaf's gradient within 1e-4 of its largest too), granite's smoke
decode at capacity factor 4.0 (logits within 1e-3), and the internlm2
batch-1 decode with the KV
sequence over "data" (the k spec's dim 2 is "data"; logits within
1e-3).  The parameter specs are ``param_specs(params, mesh)`` without
``cfg``, as the reference's tests take them: internlm2's two KV heads
then shard through a head on the 4-way model axis, which the sharded
context (``sharding._Reshard``) gathers.  Granite's MoE also prefills
sharded at the default capacity factor, where tokens drop: the routing
keeps the same (token, slot) pairs as the unsharded prefill.  One layer
of granite's MoE and of recurrentgemma's RG-LRU holds its gradients the
same way.

The reference's own sharded runs are among the seed's failures, and the
port's single-device parity with the reference is held by the other
``test_torch_*`` files, so these compare the port with itself.  Then
``kernels.ops`` with ``impl="ref"`` on DTensor inputs (batch over
"data", heads over "model", a sequence-sharded KV) equals the plain
function on the full tensors, forward and backward, and a DTensor
handed to a kernel wrapper's checks raises.
"""
import json
import socket
import traceback

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 8
TOL = {"loss": 1e-4, "weights": 1e-3, "logits": 1e-3, "grads": 1e-4}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_model(cfg, mesh):
    from repro_torch.launch import sharding as shd
    from repro_torch.models import convert
    from repro_torch.models import transformer as tfm
    model = tfm.init_lm(cfg, 0, device="cpu")
    flat = convert.lm_flat(cfg, dict(model.named_parameters()))
    return shd.distribute_lm(model, mesh, shd.param_specs(flat, mesh))


def _lm_grads(model, tokens) -> dict:
    from repro_torch.training.train_loop import _grads, lm_loss
    return _grads(model, lambda: lm_loss(model, tokens))[2]


def _rel_err(got: dict, want: dict) -> dict:
    """{leaf: the largest difference over the leaf's largest value}."""
    from repro_torch.launch.sharding import full
    return {k: float((full(got[k]).float() - w).abs().max()
                     / w.abs().max().clamp_min(1e-30))
            for k, w in want.items()}


def _train(mesh) -> dict:
    """The internlm2 smoke train step at the full learning rate
    (``warmup=1``), sharded and not.  Adam's first step moves each
    weight by about lr whatever the size of its gradient, so the weights
    alone cannot tell a wrong backward from a right one: the first
    moment after the step, (1 - b1) times the clipped gradient, is held
    per leaf against the unsharded one relative to that leaf's largest,
    and the global gradient norm against the unsharded norm."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.training import AdamW, make_train_step
    cfg = get_smoke_config("internlm2-20b").replace(dtype="float32",
                                                    remat=False)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=gen)
    opt = AdamW(lr=1e-3)
    step = make_train_step(opt, warmup=1)
    ref = tfm.init_lm(cfg, 0, device="cpu")
    s_ref, m_ref = step(ref, opt.init(dict(ref.named_parameters())),
                        {"tokens": tokens})
    model = _sharded_model(cfg, mesh)
    state = opt.init(dict(model.named_parameters()))
    batch = shd.distribute_batch({"tokens": tokens}, mesh)
    with shd.sharded(mesh) as reshard:
        state, m = step(model, state, batch)
    g_err = _rel_err(state.m, s_ref.m)
    want = dict(ref.named_parameters())
    gnorm = float(m_ref["grad_norm"])
    return {"loss_err": abs(float(shd.full(m["loss"])) - float(m_ref["loss"])),
            "grad_err": max(g_err.values()),
            "grad_worst": max(g_err, key=g_err.get),
            "grad_norm_err": abs(float(shd.full(m["grad_norm"])) - gnorm)
            / gnorm,
            "lr_scale": float(m["lr_scale"]),
            "w_err": max(float((shd.full(p) - want[k]).abs().max())
                         for k, p in model.named_parameters()),
            "sharded_leaves": sum(any(not p.is_replicate()
                                      for p in t.placements)
                                  for t in model.parameters()),
            "resharded": reshard.counts()}


GRAD_ARCHS = ("granite-moe-3b-a800m", "recurrentgemma-2b")


def _grads(mesh) -> dict:
    """The loss's gradient, sharded and not, of one layer of each family
    whose sharded backward takes other paths than internlm2's: the MoE
    layer (``MoESharding``) and the RG-LRU (an op run replicated), each
    leaf relative to its largest value.  The chunked SSD's backward
    through ``ops.local_call`` is held in ``_ops``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    out = {}
    for arch in GRAD_ARCHS:
        cfg = get_smoke_config(arch).replace(dtype="float32", remat=False,
                                             n_layers=1)
        tokens = torch.randint(0, cfg.vocab, (4, 17),
                               generator=torch.Generator().manual_seed(1))
        model = _sharded_model(cfg, mesh)
        with shd.sharded(mesh) as reshard:
            g = _lm_grads(model, shd.distribute_batch({"tokens": tokens},
                                                      mesh)["tokens"])
        g_ref = _lm_grads(tfm.init_lm(cfg, 0, device="cpu"), tokens)
        out[arch] = {"grad_err": max(_rel_err(g, g_ref).values()),
                     "leaves": len(g_ref), "resharded": reshard.counts()}
    return out


def _decode(mesh, arch, batch, prompt, **kw) -> dict:
    """Prefill unsharded, then one decode step unsharded and sharded
    (the cache distributed as ``cache_specs`` says)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config(arch).replace(dtype="float32", remat=False, **kw)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, prompt + 1), generator=gen)
    ref_model = tfm.init_lm(cfg, 0, device="cpu")
    cache = tfm.init_cache(cfg, batch, 32, dtype=torch.float32, device="cpu")
    ref_model.prefill(toks[:, :prompt], cache)
    sh_cache = tfm.Cache(index=cache.index, **{
        n: t.clone() for n, t in cache.leaves().items()})
    ref, _ = ref_model.decode_step(toks[:, prompt:], cache, prompt)
    model = _sharded_model(cfg, mesh)
    specs = shd.cache_specs(cfg, sh_cache, mesh, batch)
    shd.distribute_cache(sh_cache, mesh, specs)
    with shd.sharded(mesh) as reshard:
        tok = shd.distribute_batch({"token": toks[:, prompt:]}, mesh)["token"]
        got, _ = model.decode_step(tok, sh_cache, prompt)
    return {"err": float((shd.full(got) - ref).abs().max()),
            "resharded": reshard.counts(),
            "k_spec": list(specs["k"]),
            "cache_err": float((shd.full(sh_cache.k) - cache.k).abs().max())}


def _moe_drops(mesh) -> dict:
    """granite's smoke prefill at the default capacity factor, sharded
    and not: the kept (token, slot) pairs of every routing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("granite-moe-3b-a800m").replace(dtype="float32",
                                                           remat=False)
    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(2))
    kept, route = [], moe.route

    def recording(*a, **kw):
        out = route(*a, **kw)
        kept.append(out[4].clone())
        return out

    moe.route = recording
    try:
        ref_model = tfm.init_lm(cfg, 0, device="cpu")
        ref, _ = ref_model.prefill(toks, tfm.init_cache(
            cfg, 4, 32, dtype=torch.float32, device="cpu"))
        n_ref = len(kept)
        model = _sharded_model(cfg, mesh)
        cache = tfm.init_cache(cfg, 4, 32, dtype=torch.float32, device="cpu")
        shd.distribute_cache(cache, mesh, shd.cache_specs(cfg, cache, mesh, 4))
        with shd.sharded(mesh):
            got, _ = model.prefill(
                shd.distribute_batch({"tokens": toks}, mesh)["tokens"], cache)
    finally:
        moe.route = route
    a, b = kept[:n_ref], kept[n_ref:]
    return {"err": float((shd.full(got) - ref).abs().max()),
            "routings": [len(a), len(b)],
            "same_kept": len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)),
            "dropped": int(sum((~x).sum() for x in a))}


def _ops(mesh) -> dict:
    """Every ``ops`` entry with ``impl="ref"`` on DTensors against the
    plain function on the full tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.runtime import check_kernel_tensors
    from repro_torch.launch.sharding import full
    gen = torch.Generator().manual_seed(3)
    B, H, K, S, hd, N = 4, 8, 4, 32, 16, 8

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    def d(t, *placements):
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    q, k, v = r(B, H, S, hd), r(B, K, S, hd), r(B, K, S, hd)
    q1 = r(B, H, hd)
    kv_pos = torch.arange(S).repeat(B, 1).int()
    cur = torch.tensor([S - 1, 20, 7, 31]).int()
    b_h = (Shard(0), Shard(1))                   # batch, heads
    out = {}

    def cmp(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        out[name] = max(float((full(g).float() - w.float()).abs().max())
                        for g, w in zip(got, want))

    cmp("flash_attention",
        ops.flash_attention(d(q, *b_h), d(k, *b_h), d(v, *b_h), impl="ref"),
        ops.flash_attention(q, k, v, impl="ref"))
    cmp("decode_attention",
        ops.decode_attention(d(q1, *b_h), d(k, *b_h), d(v, *b_h),
                             d(kv_pos, Shard(0), Replicate()), cur,
                             impl="ref"),
        ops.decode_attention(q1, k, v, kv_pos, cur, impl="ref"))
    # 8 query heads over "model" (4 ranks), 2 KV heads replicated: each
    # rank's 2 query heads fall in one GQA group of 4
    k2, v2 = r(B, 2, S, hd), r(B, 2, S, hd)
    rep = (Shard(0), Replicate())
    cmp("decode_attention_one_group",
        ops.decode_attention(d(q1, *b_h), d(k2, *rep), d(v2, *rep),
                             kv_pos, cur, impl="ref"),
        ops.decode_attention(q1, k2, v2, kv_pos, cur, impl="ref"))
    cmp("flash_attention_one_group",
        ops.flash_attention(d(q, *b_h), d(k2, *rep), d(v2, *rep),
                            impl="ref"),
        ops.flash_attention(q, k2, v2, impl="ref"))
    # the sequence-sharded KV of a batch-1 decode: rows over "data"
    seq = (Shard(2), Shard(1))
    cmp("decode_attention_seq_sharded",
        ops.decode_attention(d(q1[:1], Shard(1), Shard(1)),
                             d(k[:1], *seq), d(v[:1], *seq),
                             d(kv_pos[:1], Shard(1), Shard(1)), cur[:1],
                             impl="ref"),
        ops.decode_attention(q1[:1], k[:1], v[:1], kv_pos[:1], cur[:1],
                             impl="ref"))
    qc = r(B, 3, H, hd)
    cmp("decode_attention_chunk",
        ops.decode_attention_chunk(d(qc, Shard(0), Shard(2)), d(k, *b_h),
                                   d(v, *b_h), kv_pos, cur - 3, impl="ref"),
        ops.decode_attention_chunk(qc, k, v, kv_pos, cur - 3, impl="ref"))
    logits = r(B * 2, 64)
    cmp("entropy_stats",
        ops.entropy_stats(d(logits, Shard(0), Shard(1)), impl="ref"),
        ops.entropy_stats(logits, impl="ref"))
    x, dt = r(B, S, H, hd), torch.rand(B, S, H, generator=gen) * 0.1
    A, Bm, Cm = -torch.rand(H, generator=gen), r(B, S, N), r(B, S, N)
    h0 = r(B, H, hd, N)
    cmp("ssd_chunked",
        ops.ssd_chunked(d(x, Shard(0), Shard(2)), d(dt, Shard(0), Shard(2)),
                        d(A, Replicate(), Shard(0)),
                        Bm, Cm, d(h0, Shard(0), Shard(1)), chunk=8,
                        impl="ref"),
        ops.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=8, impl="ref"))

    def grad_err(fn, ins):
        """The gradients of a fixed weighting of fn's outputs with
        respect to its float inputs ((tensor, placements) pairs), on
        DTensors against plain, relative to each input's largest."""
        want = [t.clone().requires_grad_(t.is_floating_point())
                for t, _ in ins]
        got = [d(t, *p).requires_grad_(t.is_floating_point())
               for t, p in ins]
        outs = [o if isinstance(o, tuple) else (o,)
                for o in (fn(*want), fn(*got))]
        ws = [torch.randn(o.shape, generator=gen) for o in outs[0]]
        sum((o * w).sum() for o, w in zip(outs[0], ws)).backward()
        sum((full(o) * w).sum() for o, w in zip(outs[1], ws)).backward()
        return max(float((full(g.grad) - w.grad).abs().max()
                         / w.grad.abs().max().clamp_min(1e-30))
                   for g, w in zip(got, want) if w.grad is not None)

    rr = (Replicate(), Replicate())
    out["grad_flash_attention"] = grad_err(
        lambda *a: ops.flash_attention(*a, impl="ref"),
        [(q, b_h), (k, b_h), (v, b_h)])
    out["grad_flash_attention_one_group"] = grad_err(
        lambda *a: ops.flash_attention(*a, impl="ref"),
        [(q, b_h), (k2, rep), (v2, rep)])
    out["grad_ssd_chunked"] = grad_err(
        lambda *a: ops.ssd_chunked(*a, chunk=8, impl="ref"),
        [(x, (Shard(0), Shard(2))), (dt, (Shard(0), Shard(2))),
         (A, (Replicate(), Shard(0))), (Bm, rr), (Cm, rr),
         (h0, (Shard(0), Shard(1)))])
    try:
        check_kernel_tensors("test", {"q": d(q, *b_h)},
                             dtypes={torch.float32}, align=False)
        out["check_raises"] = False
    except TypeError:
        out["check_raises"] = True
    return out


def _worker(rank: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    import warnings
    warnings.filterwarnings("ignore")
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=4, device_type="cpu")
    res = {}
    for name, fn in (("train", _train),
                     ("grads", _grads),
                     ("granite_decode", lambda m: _decode(
                         m, "granite-moe-3b-a800m", 4, 8,
                         capacity_factor=4.0)),
                     ("seq_decode", lambda m: _decode(
                         m, "internlm2-20b", 1, 16)),
                     ("moe_drops", _moe_drops),
                     ("ops", _ops)):
        try:
            res[name] = fn(mesh)
        except Exception:
            res[name] = {"error": traceback.format_exc()[-3000:]}
    if rank == 0:
        with open(path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "results.json")
    mp.spawn(_worker, args=(_free_port(), path), nprocs=WORLD, join=True)
    with open(path) as f:
        return json.load(f)


def _get(results, name):
    r = results[name]
    assert "error" not in r, r.get("error")
    return r


def test_sharded_train_step_matches_single_device(results):
    r = _get(results, "train")
    assert r["sharded_leaves"] > 0
    assert r["lr_scale"] == 1.0
    assert r["loss_err"] < TOL["loss"]
    assert r["grad_err"] < TOL["grads"], r["grad_worst"]
    assert r["grad_norm_err"] < TOL["grads"]
    assert r["w_err"] < TOL["weights"]
    assert r["resharded"]["replicated_ops"] == {}


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_match_single_device(results, arch):
    r = _get(results, "grads")[arch]
    assert r["leaves"] > 0
    assert r["grad_err"] < TOL["grads"]


def test_sharded_moe_decode_matches_single_device(results):
    r = _get(results, "granite_decode")
    assert r["k_spec"][1] == "data"
    assert r["err"] < TOL["logits"]


def test_seq_sharded_decode_batch1(results):
    r = _get(results, "seq_decode")
    assert r["k_spec"][2] == "data", r["k_spec"]
    assert r["err"] < TOL["logits"]
    assert r["cache_err"] < TOL["logits"]


def test_sharded_moe_drops_the_same_tokens(results):
    r = _get(results, "moe_drops")
    assert r["routings"][0] == r["routings"][1] > 0
    assert r["dropped"] > 0
    assert r["same_kept"]
    assert r["err"] < TOL["logits"]


@pytest.mark.parametrize("entry", [
    "flash_attention", "decode_attention", "decode_attention_seq_sharded",
    "decode_attention_one_group", "flash_attention_one_group",
    "decode_attention_chunk", "entropy_stats", "ssd_chunked"])
def test_ops_on_dtensors_equal_plain(results, entry):
    assert _get(results, "ops")[entry] < 1e-5


@pytest.mark.parametrize("entry", [
    "flash_attention", "flash_attention_one_group", "ssd_chunked"])
def test_ops_gradients_on_dtensors_equal_plain(results, entry):
    """The backward through ``local_call``: an input that a mesh dim
    holds whole while it splits the work gets the sum of every rank's
    partial gradient (the KV heads of one GQA group, SSD's B and C)."""
    assert _get(results, "ops")[f"grad_{entry}"] < TOL["grads"]


def test_check_kernel_tensors_refuses_dtensor(results):
    assert _get(results, "ops")["check_raises"]
