"""Multi-pod dry run, ported from ``repro.launch.dryrun`` without XLA:
every (arch x input shape) stepped once on the production mesh, with the
per-rank costs, collectives, memory and a modelled roofline recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \
        --shape train_4k --mesh single --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

It runs in its own process, on ``torch.distributed``'s fake process group
(``FakeStore``, backend ``"fake"``): one process stands in for rank 0 of
256 ranks (``single``, 16 x 16) or 512 (``multipod``, 2 x 16 x 16), its
collectives return at once, and it never touches a card.  The model is
built on the meta device (``models.transformer.abstract_lm``: shapes and
dtypes, no memory), its parameters, optimiser moments, cache and inputs
are sharded as ``launch.sharding`` says, and the train, prefill or
decode step runs once under ``sharding.sharded(mesh)`` (``build_step``,
the counterpart of the reference's ``build_lowered``).

What is counted, per rank (``_Costs``, a dispatch mode that lets each
DTensor op run and counts the local ops it issues):
  - flops: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's)
    on each local product, so a model-sharded product counts its local
    width, and work that a refused placement replicates counts in full;
  - bytes: every local op's tensor inputs read once and outputs written
    once, views aside (a cache write by index counts its rows, not the
    cache): eager PyTorch fuses nothing, so this overstates
    a fused kernel's traffic, as XLA-CPU's "bytes accessed" did;
    ``analytic_bytes_floor`` bounds the truth from below;
  - collectives: each functional collective's wire bytes from its
    tensor's bytes and its group's size, with the reference's ring
    factors (``collective_bytes``); ``CommDebugMode`` counts them too
    (``--print-hlo`` prints its table in place of the HLO);
  - resharded: the ops for which the sharded context gave up a shard
    (``sharding._Reshard``), by op: views taken on gathered input, and
    ops run on gathered values, replicated, whose full work the flops
    and bytes above then hold.
Eager layers each run once, so nothing needs the reference's
extrapolation over a scanned layer.  Memory is the local bytes of what
the step holds (parameters, optimiser moments, cache and inputs);
temporaries are null: meta tensors allocate nothing, so no allocator
sees them.  The roofline is ``core.energy.EnergyModel``'s, on the H100
SXM data sheet's constants: its times are modelled, not measured.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, applicable,
                                 get_config, get_shape, shape_variant)
from repro_torch.core.energy import EnergyModel
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.models import convert, quant
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import torch_dtype
from repro_torch.training import AdamW, make_train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_c10d = torch.ops._c10d_functional
# ops that move no data: allocation, views not marked as such, and the
# wrappers of a collective's result (its bytes are counted as wire bytes)
_aten = torch.ops.aten
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten._unsafe_view.default,
         _aten.detach.default, _aten.alias.default,
         _c10d._wrap_tensor_autograd.default, _c10d.wait_tensor.default}
_KIND = {_c10d.all_gather_into_tensor: "all-gather",
         _c10d.all_reduce: "all-reduce",
         _c10d.reduce_scatter_tensor: "reduce-scatter",
         _c10d.all_to_all_single: "all-to-all",
         _c10d.broadcast: "collective-permute"}


def collective_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Wire bytes of one collective over a group of ``g`` from its
    result's bytes S, the reference's ring factors:

        all-reduce       2 (g-1)/g S      (reduce-scatter + all-gather)
        all-gather         (g-1)/g S      (S = gathered result)
        reduce-scatter     (g-1)   S      (S = scattered shard)
        all-to-all         (g-1)/g S
        collective-permute          S
    """
    if g <= 1:
        return 0.0
    return {"all-reduce": 2.0 * (g - 1) / g, "all-gather": (g - 1) / g,
            "reduce-scatter": float(g - 1), "all-to-all": (g - 1) / g,
            "collective-permute": 1.0}[kind] * result_bytes


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _Costs(TorchDispatchMode):
    """Per-rank flops, bytes and collective wire bytes of the local ops
    that run under it (the module docstring says what each counts)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {c: 0.0 for c in _COLLECTIVES}
        self.coll["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor issue its local ops
        out = func(*args, **kwargs)
        leaves = torch.utils._pytree.tree_leaves((args, kwargs, out))
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out       # DTensor working out a global output's shape
        packet = func._overloadpacket
        kind = _KIND.get(packet)
        if kind is not None:
            group = dist.distributed_c10d._resolve_process_group(args[-1])
            self.coll[kind] += collective_bytes(kind, _nbytes(out),
                                                group.size())
            self.coll["count"] += 1
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func is _aten.index_put_.default:      # a cache write: its rows
            self.bytes += 2 * _nbytes(args[2]) + sum(
                _nbytes(t) for t in args[1] if t is not None)
        elif not func.is_view and func not in _FREE:
            self.bytes += sum(_nbytes(t) for t in leaves)
        return out


def _count(run) -> dict:
    """Run ``run()`` once under ``_Costs`` and ``CommDebugMode``; its
    result is the sharded context's counts of the ops that gave up a
    shard."""
    costs, comm = _Costs(), CommDebugMode()
    with comm, costs:
        resharded = run()
    coll = dict(costs.coll)
    coll["total"] = sum(coll[c] for c in _COLLECTIVES)
    return {"flops": float(costs.flops), "bytes": float(costs.bytes),
            "collectives": coll, "comm": comm, "resharded": resharded}


# ---------------------------------------------------------------------------
# abstract inputs per (arch, shape)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, *, mode: str) -> dict:
    """Meta stand-ins for every model input (no allocation), matching
    what the step consumes; a decode step's ``pos`` is its position, an
    int: the step writes the last row of a ``seq_len`` cache."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def meta(*size, dtype=dt):
        return torch.empty(size, dtype=dtype, device="meta")

    out = {}
    if mode in ("train", "prefill"):
        out["tokens"] = meta(B, S + (mode == "train"), dtype=torch.int32)
        if cfg.family == "encdec":
            out["enc_embeds"] = meta(B, cfg.enc_seq,
                                     cfg.enc_d_model or cfg.d_model)
        if cfg.family == "vlm":
            out["prefix_embeds"] = meta(B, cfg.n_patches, cfg.d_model)
    else:  # decode: ONE new token against a seq_len cache
        out["token"] = meta(B, 1, dtype=torch.int32)
        out["pos"] = S - 1
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·tokens for training, 2·N_active·tokens
    otherwise (the §Roofline 'useful' figure)."""
    n_act = cfg.n_active_params()
    tokens = shape.global_batch * (
        shape.seq_len if shape.mode != "decode" else 1)
    return 6.0 * n_act * tokens if shape.mode == "train" \
        else 2.0 * n_act * tokens


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _local_bytes(tensors) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tensors)


def _set_parameters(model: tfm.LM, flat: dict) -> None:
    """Put a flat dict in the reference's layout into ``model``'s
    parameters (per layer, as ``convert.lm_unflat`` keys them)."""
    for key, t in convert.lm_unflat(model.cfg, flat).items():
        mod_name, _, pname = key.replace("/", ".").rpartition(".")
        setattr(model.get_submodule(mod_name), pname,
                nn.Parameter(t, requires_grad=False))


def build_step(cfg, shape, mesh, *, fsdp: bool = False,
               seq_shard_kv: bool = False, quant_int8: bool = False):
    """-> (run, held): ``run()`` takes one train, prefill or decode step
    of ``cfg`` at ``shape`` on ``mesh``, under ``sharding.sharded(mesh)``,
    on meta DTensors, and returns the context's counts of the ops that
    gave up a shard; ``held`` maps "params", "opt", "cache" and
    "inputs" to the local bytes the step holds.  Shardings: parameters
    by the path rules (with ``fsdp``, 2D), the batch over (pod, data),
    the cache by ``cache_specs`` (with ``seq_shard_kv``, the KV sequence
    over "model" where the heads do not divide).  ``quant_int8`` (decode
    only) holds the weights as ``quant.quantize_tree``'s int8 tree; the
    step gathers the int8 storage to the tensor-parallel specs (the FSDP
    all-gather at one byte a weight) and then dequantises, as the
    reference's does."""
    B, S = shape.global_batch, shape.seq_len
    model = tfm.abstract_lm(cfg)
    flat = convert.lm_flat(cfg, dict(model.named_parameters()))
    p_spec = shd.param_specs(flat, mesh, cfg=cfg, fsdp=fsdp)
    ins = shd.distribute_batch(input_specs(cfg, shape, mode=shape.mode),
                               mesh)
    inputs = [t for t in ins.values() if isinstance(t, torch.Tensor)]
    embeds = {k: ins[k] for k in ("prefix_embeds", "enc_embeds") if k in ins}
    held = {"opt": 0, "cache": 0, "inputs": _local_bytes(inputs)}

    if shape.mode == "train":
        shd.distribute_lm(model, mesh, p_spec)
        held["params"] = _local_bytes(model.parameters())
        opt = AdamW()
        state = opt.init(dict(model.named_parameters()))
        held["opt"] = _local_bytes([*state.m.values(), *state.v.values()])
        step = make_train_step(opt)
        batch = {"tokens": ins["tokens"], **embeds}

        def run():
            with shd.sharded(mesh) as reshard:
                step(model, state, batch)
            return reshard.counts()
        return run, held

    cache = tfm.abstract_cache(cfg, B, S)
    shd.distribute_cache(cache, mesh, shd.cache_specs(
        cfg, cache, mesh, B, seq_shard_kv=seq_shard_kv))
    held["cache"] = _local_bytes(cache.leaves().values())

    if shape.mode == "prefill":
        shd.distribute_lm(model, mesh, p_spec)
        held["params"] = _local_bytes(model.parameters())

        def run():
            with shd.sharded(mesh) as reshard:
                model.prefill(ins["tokens"], cache, **embeds)
            return reshard.counts()
        return run, held

    if not quant_int8:
        shd.distribute_lm(model, mesh, p_spec)
        held["params"] = _local_bytes(model.parameters())

        def run():
            with shd.sharded(mesh) as reshard:
                model.decode_step(ins["token"], cache, ins["pos"])
            return reshard.counts()
        return run, held

    q_spec = quant.quantize_specs(p_spec, flat)
    qparams = {}
    for k, v in quant.quantize_tree(flat).items():
        qparams[k] = ({n: shd.distribute(v[n], mesh, q_spec[k][n])
                       for n in ("q", "scale")}
                      if isinstance(v, dict) else
                      shd.distribute(v, mesh, q_spec[k]))
    held["params"] = _local_bytes(torch.utils._pytree.tree_leaves(qparams))
    # the gather target: tensor-parallel-only specs
    gather = quant.quantize_specs(
        shd.param_specs(flat, mesh, cfg=cfg, fsdp=False), flat)

    def run():
        with shd.sharded(mesh) as reshard:
            q = qparams
            if fsdp:
                q = torch.utils._pytree.tree_map(
                    lambda t, s: t.redistribute(
                        mesh, shd.to_placements(s, mesh)),
                    qparams, gather, is_leaf=lambda x: isinstance(x, tuple))
            _set_parameters(model, quant.dequantize_tree(q))
            model.decode_step(ins["token"], cache, ins["pos"])
        return reshard.counts()
    return run, held


def exact_costs(cfg, shape, mesh, **kw) -> tuple[float, float]:
    """Per-device (flops, bytes) of one step, as ``_Costs`` counts them.
    The reference extrapolated a scanned layer, which XLA's cost
    analysis counts once, from 1- and 2-layer compiles; eager layers
    each run and count once, so here there is nothing to correct."""
    c = _count(build_step(cfg, shape, mesh, **kw)[0])
    return c["flops"], c["bytes"]


def analytic_bytes_floor(cfg, shape, n_chips: int) -> float:
    """Lower-bound HBM bytes/device: params once + decode cache once
    (+ token activations).  The counted bytes overstate a fused
    kernel's traffic (explicit f32 converts of bf16 operands that a
    fused product never materialises); reporting the analytic floor
    alongside bounds the truth from below."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    params = cfg.n_params() * (dt if shape.mode != "train" else dt * 4)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.mode != "decode" else 1)
    acts = tokens * cfg.d_model * dt * max(cfg.n_layers // 4, 1)
    cache = 0.0
    if shape.mode == "decode":
        for kind in cfg.block_kinds:
            if kind == "attn":
                cache += (shape.global_batch * shape.seq_len
                          * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
            elif kind == "local_attn":
                cache += (shape.global_batch * min(shape.seq_len,
                                                   cfg.window or 10 ** 9)
                          * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
            elif kind == "mla":
                cache += (shape.global_batch * shape.seq_len
                          * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2)
            elif kind == "ssd":
                din = cfg.ssm_expand * cfg.d_model
                nh = din // cfg.ssm_headdim
                cache += (shape.global_batch * nh * cfg.ssm_headdim
                          * cfg.ssm_state * 4)
            elif kind == "rglru":
                cache += shape.global_batch * (cfg.lru_width
                                               or cfg.d_model) * 4
    if shape.mode == "train":
        acts *= 2  # fwd + remat re-read
    return (params + cache + acts) / n_chips


def pad_heads(cfg, tp: int):
    """Pad attention heads up to a multiple of the model axis (MaxText-
    style deployment trick): the padded model has ceil(H/tp)*tp heads
    (extra heads zero-initialised, masked by zero out-proj rows), so
    attention shards instead of replicating.  +H_pad/H extra attention
    FLOPs, -(tp-1)/tp replicated compute."""
    H = cfg.n_heads
    if H == 0 or H % tp == 0:
        return cfg
    Hp = -(-H // tp) * tp
    K = cfg.n_kv_heads
    Kp = K if K <= 1 or Hp % K == 0 else Hp
    return cfg.replace(n_heads=Hp, n_kv_heads=Kp)


@contextlib.contextmanager
def fake_group(world: int):
    """The fake process group of ``world`` ranks, this process rank 0;
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            fsdp: bool = False, seq_shard_kv: bool = False,
            do_pad_heads: bool = False, quant_int8: bool = False,
            remat: str = "full", print_table: bool = False) -> dict:
    """One (arch, shape, mesh) record; the fake group of the mesh's size
    must be up (``fake_group``)."""
    shape = get_shape(shape_name)
    base = get_config(arch)
    ok, note = applicable(base, shape)
    if fsdp:
        note += "+fsdp"
    if seq_shard_kv:
        note += "+seqkv"
    if do_pad_heads:
        note += "+padheads"
    if quant_int8:
        note += "+int8"
    if remat != "full":
        note += f"+remat-{remat}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": note, "status": "skip" if not ok else "pending"}
    if not ok:
        return rec
    cfg = shape_variant(base, shape)
    if remat != "full":
        cfg = cfg.replace(remat=remat != "none", remat_policy=remat)
    multi = mesh_kind == "multipod"
    if do_pad_heads:
        cfg = pad_heads(cfg, 16)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    n_chips = 512 if multi else 256

    kw = {"fsdp": fsdp, "seq_shard_kv": seq_shard_kv,
          "quant_int8": quant_int8 and shape.mode == "decode"}
    t0 = time.time()
    run, held = build_step(cfg, shape, mesh, **kw)
    t_build = time.time() - t0
    t0 = time.time()
    c = _count(run)
    t_step = time.time() - t0
    if print_table:
        print(c["comm"].generate_comm_debug_tracing_table(noise_level=0),
              flush=True)

    em = EnergyModel()
    terms = em.roofline(c["flops"], c["bytes"],
                        float(c["collectives"]["total"]), n_chips=1)
    mf = model_flops(cfg, shape)
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "build_s": round(t_build, 2),
        "step_s": round(t_step, 2),
        "memory": {
            "param_bytes": held["params"],
            "opt_bytes": held["opt"],
            "cache_bytes": held["cache"],
            "input_bytes": held["inputs"],
            "temp_bytes": None,
            "temp_note": "meta tensors allocate nothing, so no allocator "
                         "sees the step's temporaries",
        },
        "flops_per_device": c["flops"],
        "bytes_per_device": c["bytes"],
        "bytes_floor_per_device": analytic_bytes_floor(cfg, shape, n_chips),
        "collectives": c["collectives"],
        "comm_counts": {str(k): v for k, v in
                        c["comm"].get_comm_counts().items()},
        "resharded": c["resharded"],
        "roofline": {
            "modelled": "EnergyModel() on the H100 SXM data sheet's "
                        "constants; the times are modelled, not measured",
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "bottleneck": terms.bottleneck,
            "step_time_s": terms.step_time_s,
        },
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (c["flops"] * n_chips)
                               if c["flops"] else None),
        "energy_j_per_step": em.joules(terms, n_chips=n_chips),
    })
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multipod", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--print-hlo", action="store_true",
                    help="print CommDebugMode's table of each step")
    ap.add_argument("--fsdp", action="store_true",
                    help="2D (data x model) weight sharding")
    ap.add_argument("--seq-shard-kv", action="store_true",
                    help="shard KV sequence over model when heads don't "
                         "divide")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad attention heads to the model-axis size")
    ap.add_argument("--quant-int8", action="store_true",
                    help="int8 weights for decode shapes")
    ap.add_argument("--remat", choices=["full", "dots", "none"],
                    default="full", help="train-step remat policy")
    ap.add_argument("--suffix", default="",
                    help="output filename suffix for variant runs")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for mesh_kind in meshes:
        shape = PRODUCTION_SHAPES[mesh_kind == "multipod"][0]
        with fake_group(math.prod(shape)):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}__{mesh_kind}" + args.suffix
                    try:
                        rec = run_one(arch, shape, mesh_kind, fsdp=args.fsdp,
                                      seq_shard_kv=args.seq_shard_kv,
                                      do_pad_heads=args.pad_heads,
                                      quant_int8=args.quant_int8,
                                      remat=args.remat,
                                      print_table=args.print_hlo)
                    except Exception as e:  # a failure is a fault to record
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_kind, "status": "fail",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-4000:]}
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=2)
                    st = rec["status"]
                    n_ok += st == "ok"
                    n_skip += st == "skip"
                    n_fail += st == "fail"
                    msg = f"[{st:4s}] {tag}"
                    if st == "ok":
                        r = rec["roofline"]
                        msg += (f"  step {rec['step_s']:.1f}s  "
                                f"bottleneck={r['bottleneck']}  "
                                f"modelled step={r['step_time_s']*1e3:.2f}ms")
                        rep = rec["resharded"]["replicated_ops"]
                        if rep:
                            msg += f"  replicated={rep}"
                    elif st == "fail":
                        msg += "  " + rec["error"][:160]
                    print(msg, flush=True)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_fail} fail", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
