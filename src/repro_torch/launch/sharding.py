"""Logical-axis sharding policy, ported from ``repro.launch.sharding``
onto ``torch.distributed``'s DTensor.

``param_specs`` gives each parameter a spec from path-pattern rules
(Megatron row/column alternation for attention and MLP, expert sharding
for MoE, vocab sharding for embeddings).  A spec is a tuple with one
entry per leading tensor dimension: a mesh axis name, a tuple of names
for a dimension split over several axes (``("pod", "data")``), or None
(the reference's ``PartitionSpec`` as a tuple).  Every rule is guarded
by divisibility: a dimension that does not divide the "model" axis falls
back to replication (recurrentgemma's 10 Q heads on a 16-way model axis,
granite's 40 experts).  The rules, their fallbacks and ``_add_fsdp`` are
the reference's, so the specs equal its specs leaf for leaf, including
where ``_add_fsdp`` picks a stacked layer dimension.

The specs are worked out on the reference's flat layout
(``convert.lm_flat`` of ``named_parameters()`` or of AdamW's moments:
``layers/mix/wq`` stacked ``[L, ...]`` for a homogeneous stack,
``layers/2/mix/wq`` per layer for a mixed one), matched on ``"/" +
key``, the reference's path string.  ``cache_specs`` takes the port's
``Cache``, whose leaves are named otherwise; it maps each to the
reference's path (``_CACHE_PATHS``).  Only ``.shape`` is read, so meta
tensors and shape stubs do.

``to_placements`` turns a spec into DTensor placements (the counterpart
of ``to_named``).  ``distribute_lm`` / ``distribute_cache`` /
``distribute_batch`` turn a model's parameters, a cache and a batch
into DTensors in place: the port keeps one module per layer, so a
stacked leaf's spec goes to each layer without its lead L entry.
``sharded(mesh)`` is the context a sharded step runs in: plain tensors
(rotary tables, positions) count as replicated, and the MoE layers
route on the gathered tokens (``MoESharding``), the counterpart of the
reference's activation constraint.

For decode shapes whose batch cannot use the data axis (long_500k,
batch 1), the KV cache's SEQUENCE dim takes the "data" axis instead.
The einsum attention reads such a cache as DTensor ops; the hand
kernels take it through ``kernels.ops``, which gathers its rows first.
"""
from __future__ import annotations

import collections
import contextlib
import math
import re
import warnings

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes, model_axis_size
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

# (path regex, spec builder).  "M" marks the model axis; trailing dims
# match from the right so stacked-layer leading dims are untouched.
_RULES: list[tuple[str, tuple]] = [
    (r"/emb$",                  ("M", None)),
    (r"/unemb$",                (None, "M")),
    (r"/(wq|wk|wv)$",           (None, "M")),
    (r"/(bq|bk|bv)$",           ("M",)),
    (r"/wo$",                   ("M", None)),
    (r"/bo$",                   (None,)),
    (r"moe/router$",            (None, None)),
    (r"moe/w_(gate|up)$",       ("E", None, "M")),
    (r"moe/w_down$",            ("E", "M", None)),
    (r"/(mlp|encoder.*)/w_(gate|up)$", (None, "M")),
    (r"/w_(gate|up)$",          (None, "M")),
    (r"/w_up$",                 (None, "M")),
    (r"/b_up$",                 ("M",)),
    (r"/w_down$",               ("M", None)),
    (r"/b_down$",               (None,)),
    # MLA
    (r"/w_dq$",                 (None, None)),
    (r"/w_uq$",                 (None, "M")),
    (r"/w_dkv$",                (None, None)),
    (r"/w_uk$",                 (None, "M", None)),
    (r"/w_uv$",                 (None, "M", None)),
    # RG-LRU (width dim sharded)
    (r"/w_in$",                 (None, "M")),
    (r"/conv_w$",               (None, "M")),
    (r"/conv_b$",               ("M",)),
    (r"/(w_a|w_x)$",            (None, "M")),
    (r"/(b_a|b_x|lam)$",        ("M",)),
    (r"/w_out$",                ("M", None)),
    # SSD
    (r"/in_proj$",              (None, "M")),
    (r"/out_proj$",             ("M", None)),
    (r"/(A_log|D|dt_bias)$",    (None,)),
]


def _resolve(rule: tuple, shape: tuple, tp: int) -> tuple:
    """Apply a right-aligned rule with divisibility fallbacks."""
    ndim = len(shape)
    spec: list = [None] * ndim
    k = len(rule)
    if k > ndim:
        rule = rule[k - ndim:]
        k = ndim
    for i, r in enumerate(rule):
        dim = ndim - k + i
        if r in ("M", "E"):
            if tp > 1 and shape[dim] % tp == 0 and shape[dim] >= tp:
                spec[dim] = "model"
        # "E" (expert) falls back to the *next* M rule dim if it fails,
        # handled by the rule author listing M on the alternative dim.
    # ensure no two dims share the axis
    seen = False
    for i, s in enumerate(spec):
        if s == "model":
            if seen:
                spec[i] = None
            seen = True
    return tuple(spec)


# attention projections whose sharded output dim is a flattened
# (heads x head_dim) axis: sharding must align with head boundaries or
# the in-layer reshape to [B,S,H,hd] forces an activation all-gather
_HEAD_ALIGNED = {
    "wq": "n_heads", "bq": "n_heads", "w_uq": "n_heads",
    "wk": "n_kv_heads", "bk": "n_kv_heads",
    "wv": "n_kv_heads", "bv": "n_kv_heads",
    "wo": "n_heads", "w_uk": "n_heads", "w_uv": "n_heads",
}


def param_specs(params: dict, mesh, *, cfg: ModelConfig | None = None,
                fsdp: bool = False) -> dict:
    """{key: spec} for a flat dict in the reference's layout (only
    ``.shape`` is read).

    ``cfg`` enables head-aligned guards: attention projections only
    shard when the HEAD COUNT divides the model axis, not merely the
    flattened dim (see ``_HEAD_ALIGNED``).

    ``fsdp=True`` additionally shards the largest not-yet-sharded dim of
    every big (>= 1 Mi elements) leaf over the "data" axis (2D weight
    sharding / FSDP): llama3-405b's weights at 16-way tensor parallelism
    are 50 GB a rank, 3.2 GB at 256-way; it costs an all-gather a layer.
    """
    tp = model_axis_size(mesh)
    dp = axis_sizes(mesh).get("data", 1)

    def head_ok(ps: str) -> bool:
        if cfg is None:
            return True
        attr = _HEAD_ALIGNED.get(ps.rsplit("/", 1)[-1])
        if attr is None:
            return True
        heads = getattr(cfg, attr, 0)
        return heads > 0 and heads % tp == 0

    def assign(key: str, shape: tuple) -> tuple:
        ps = "/" + key
        spec = ()
        for pat, rule in _RULES:
            if re.search(pat, ps):
                if head_ok(ps):
                    spec = _resolve(rule, shape, tp)
                break
        if fsdp and dp > 1 and math.prod(shape) >= (1 << 20):
            spec = _add_fsdp(spec, shape, dp)
        return spec

    return {k: assign(k, tuple(t.shape)) for k, t in params.items()}


def _add_fsdp(spec: tuple, shape: tuple, dp: int) -> tuple:
    lst = list(spec) + [None] * (len(shape) - len(spec))
    # the largest unsharded dim that divides the data axis (the
    # reference's rule: a stacked L dim is a candidate too)
    cands = [(shape[i], i) for i in range(len(shape))
             if lst[i] is None and shape[i] % dp == 0 and shape[i] >= dp]
    if not cands:
        return tuple(lst)
    _, dim = max(cands)
    lst[dim] = "data"
    return tuple(lst)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------

def batch_spec_axis(mesh, global_batch: int):
    """The mesh axes usable for the batch dim (None if not divisible)."""
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in axes)
    if axes and global_batch % n == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def tokens_spec(mesh, global_batch: int) -> tuple:
    return (batch_spec_axis(mesh, global_batch), None)


def frontend_spec(mesh, global_batch: int) -> tuple:
    """[B, Senc/patches, D] stub embeddings."""
    return (batch_spec_axis(mesh, global_batch), None, None)


# the reference's cache path of each of the port's cache leaves: the
# port stacks every kind (a mixed stack's too), and the rules below read
# dimensions from the right, so a stacked leaf's spec is the reference's
# per-layer spec after a lead None
_CACHE_PATHS = {"k": "/layers/kv/k", "v": "/layers/kv/v",
                "pos": "/layers/kv/pos", "c_kv": "/layers/kv/c_kv",
                "k_rope": "/layers/kv/k_rope", "h": "/layers/rec/h",
                "lru_h": "/layers/rec/h", "conv": "/layers/rec/conv",
                "lru_conv": "/layers/rec/conv", "cross_k": "/cross/0",
                "cross_v": "/cross/1"}


def cache_specs(cfg: ModelConfig, cache, mesh, global_batch: int, *,
                seq_shard_kv: bool = False) -> dict:
    """{leaf name: spec} for the port's decode ``Cache``.

    KV tensors are [L, B, S, K|r, hd]; batch shards over ("pod","data")
    when divisible, otherwise the SEQUENCE dim takes the "data" axis
    (sequence-sharded decode).  Head dims shard over "model" when
    divisible; when they are NOT divisible (llama's 8 KV heads on a
    16-way model axis) and ``seq_shard_kv`` is set, the SEQUENCE dim
    takes the "model" axis instead.  MLA latent / recurrent states shard
    their channel dims.  A paged pool raises: the reference never shards
    one."""
    if cache.block_table is not None:
        raise ValueError("cache_specs: a paged KV pool is not sharded (the "
                         "reference shards contiguous caches only)")
    tp = model_axis_size(mesh)
    baxis = batch_spec_axis(mesh, global_batch)
    data = "data" if "data" in axis_sizes(mesh) else None
    seq_axis = None if baxis is not None else data

    def assign(ps: str, shape: tuple) -> tuple:
        nd = len(shape)
        spec = [None] * nd
        if re.search(r"/(k|v)$", ps) and nd >= 4:
            # [L?, B, S, K, hd]
            spec[nd - 4] = baxis
            spec[nd - 3] = seq_axis
            if shape[nd - 2] % tp == 0:
                spec[nd - 2] = "model"
            elif seq_shard_kv and spec[nd - 3] is None:
                spec[nd - 3] = "model"        # seq-sharded decode
            return tuple(spec)
        if re.search(r"/(c_kv|k_rope)$", ps) and nd >= 3:   # [L?, B, S, r]
            spec[nd - 3] = baxis
            spec[nd - 2] = seq_axis
            return tuple(spec)
        if re.search(r"/pos$", ps) and nd >= 2:      # [L?, B, S]
            spec[nd - 2] = baxis
            spec[nd - 1] = seq_axis
            return tuple(spec)
        if re.search(r"/rec/h$", ps):
            if nd <= 3:                               # rglru [L?, B, R]
                spec[nd - 2] = baxis
                if shape[-1] % tp == 0:
                    spec[-1] = "model"                # RG-LRU width
            else:                                     # ssd [L?, B,H,hd,N]
                spec[nd - 4] = baxis
                if shape[nd - 3] % tp == 0:
                    spec[nd - 3] = "model"            # SSD heads
            return tuple(spec)
        if re.search(r"/conv$", ps):                  # [L?,B,W-1,C]
            spec[nd - 3] = baxis
            if shape[-1] % tp == 0:
                spec[-1] = "model"
            return tuple(spec)
        if re.search(r"/cross", ps) and nd >= 4:      # [L,B,Senc,K,hd]
            spec[1] = baxis
            if shape[nd - 2] % tp == 0:
                spec[nd - 2] = "model"
            return tuple(spec)
        return ()                                     # lengths etc.

    return {n: assign(_CACHE_PATHS[n], tuple(t.shape))
            for n, t in cache.leaves().items()}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where tensor dim d's
    entry names that mesh axis (alone or in a tuple, major axis first,
    as the mesh orders them), else ``Replicate()``."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: tuple) -> DTensor:
    """``t`` (the same full tensor on every rank: seeded weights, zeroed
    caches) as a DTensor placed by ``spec``; each rank keeps its own
    shard, a contiguous copy, without a broadcast from rank 0."""
    return distribute_tensor(t, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


def _stacks(cfg: ModelConfig) -> list[str]:
    """The prefixes ``convert.lm_flat`` stacks along a lead L dim."""
    out = ["layers"] if cfg.homogeneous else []
    if cfg.family == "encdec":
        out += ["encoder/layers", "xattn"]
    return out


def layer_spec(cfg: ModelConfig, name: str, specs: dict) -> tuple:
    """The spec of the parameter ``name`` (``named_parameters()``'s, one
    module per layer) from ``specs`` on the flat layout: a stacked leaf's
    without its lead entry.  Raises, naming the leaf, when a mesh axis
    sits on the stacked L dim (a layer cannot hold part of another)."""
    parts = name.split(".")
    for prefix in _stacks(cfg):
        head = prefix.split("/")
        n = len(head)
        if parts[:n] == head and len(parts) > n + 1 and parts[n].isdigit():
            key = "/".join(head + parts[n + 1:])
            spec = specs[key]
            if spec and spec[0] is not None:
                raise ValueError(
                    f"{key}: spec {spec} puts mesh axis {spec[0]!r} on the "
                    f"stacked layer dim; the port holds one tensor a layer")
            return tuple(spec[1:])
    return specs["/".join(parts)]


def distribute_lm(model: nn.Module, mesh, specs: dict) -> nn.Module:
    """Replace every parameter of ``model`` (an ``LM``) by a DTensor
    placed as ``specs`` (``param_specs`` of ``convert.lm_flat(cfg,
    dict(model.named_parameters()))``) says, in place; -> ``model``."""
    cfg = model.cfg
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            dt = distribute(p.detach(), mesh, layer_spec(cfg, name, specs))
            setattr(mod, pname, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def distribute_cache(cache, mesh, specs: dict):
    """Replace every per-slot tensor of ``cache`` (a contiguous
    ``Cache``) by a DTensor placed as ``specs`` (``cache_specs``) says,
    in place; -> ``cache``."""
    for name, t in cache.leaves().items():
        setattr(cache, name, distribute(t, mesh, specs[name]))
    return cache


def distribute_batch(batch: dict, mesh) -> dict:
    """A new dict of DTensors: ``tokens`` (or a decode step's ``token``)
    [B, S] by ``tokens_spec``, ``prefix_embeds`` / ``enc_embeds`` [B, *,
    D] by ``frontend_spec``; other entries pass through."""
    out = dict(batch)
    for name, t in batch.items():
        if name in ("tokens", "token"):
            out[name] = distribute(t, mesh, tokens_spec(mesh, t.shape[0]))
        elif name in ("prefix_embeds", "enc_embeds"):
            out[name] = distribute(t, mesh, frontend_spec(mesh, t.shape[0]))
    return out


def full(t):
    """A DTensor's whole value as a plain tensor on every rank (an
    all-gather where it is sharded); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# the MoE activation constraint, and the context of a sharded step
# ---------------------------------------------------------------------------

class MoESharding:
    """What an MoE layer does under a mesh (``models.moe.moe_forward``
    reads it from ``moe.ACTIVATION_SHARDING``).  The routing, its
    capacity and the dispatch by index run on the gathered tokens, as
    plain tensors on every rank, so the same tokens drop as in an
    unsharded step; the expert products then run as DTensor ops on the
    dispatched rows, placed as the reference's constraint places its
    [G, g, E, C] intermediates (``dryrun.py:165-193``): the expert dim
    over "model" and a token dim over the batch axes, each only when it
    divides."""

    def __init__(self, mesh):
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        self.baxes = batch_axes(mesh)
        self.bsize = math.prod(sizes[a] for a in self.baxes)
        self.tp = sizes.get("model", 1)

    @staticmethod
    def gather(x):
        return full(x)

    def constrain(self, x: torch.Tensor, roles: tuple) -> DTensor:
        """A plain tensor, the same on every rank, as a DTensor whose
        "experts" dim is over "model" and "tokens" dim over the batch
        axes where they divide (a local split: no collective)."""
        spec = []
        for dim, role in enumerate(roles):
            if (role == "tokens" and self.bsize > 1
                    and x.shape[dim] % self.bsize == 0):
                spec.append(self.baxes if len(self.baxes) > 1
                            else self.baxes[0])
            elif (role == "experts" and self.tp > 1
                  and x.shape[dim] % self.tp == 0):
                spec.append("model")
            else:
                spec.append(None)
        return _place(x, self.mesh, to_placements(tuple(spec), self.mesh))

    def like(self, y: torch.Tensor, x=None) -> DTensor:
        """A result y (plain, the same on every rank) as a DTensor placed
        as the layer's input x, its partial sums replicated, or
        replicated without x (the aux loss): a local split.  A DTensor,
        so that the gradient reaching the plain routing graph is plain
        too."""
        placements = ([p if isinstance(p, Shard) else Replicate()
                       for p in x.placements] if isinstance(x, DTensor)
                      else [Replicate()] * self.mesh.ndim)
        return _place(y, self.mesh, placements)


def _place(t: torch.Tensor, mesh, placements) -> DTensor:
    """A plain tensor that is the same on every rank as a DTensor with
    ``placements``: a local split, differentiable (``distribute_tensor``
    detaches)."""
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


_aten = torch.ops.aten
_VIEWS = {_aten.view.default, _aten._unsafe_view.default}


def _is_shard(p) -> bool:
    """A placement that splits a tensor dim: ``Shard``, or the strided
    shard DTensor makes of a dim split over two mesh dims and then
    viewed (not a ``Shard`` subclass in every release)."""
    return not (p.is_replicate() or p.is_partial())


class _Reshard(TorchDispatchMode):
    """What DTensor refuses where XLA inserts the collective, in the
    forward and in the backward alike.

    A view that cannot keep a shard (it would alias a redistributed
    copy): the model splits flattened heads ([B, S, K*hd] -> [B, S, K,
    hd]) and GQA groups ([.., H, hd] -> [.., K, G, hd]), which a
    model-axis shard survives only when K divides the axis.  On such a
    refusal the input's shards are replicated, from the last mesh dim
    (the model axis) back, until the view is taken (all at once where
    DTensor cannot take a strided shard apart one mesh dim at a time).
    The result then views the gathered copy; the model writes in place
    only into its cache's layer selects, which keep their shards.

    An in-place write by index (``_index_put``: a cache write), which
    some PyTorch releases shard by no strategy at all and which may not
    move its target's shards.

    And an op DTensor has no sharding strategy for (RG-LRU's
    ``log_sigmoid_backward``), or whose strategy or redistribution
    fails on its inputs' placements (some releases fail so on the
    multi-pod mesh), unless it writes in place or is a view: it runs on
    the gathered values, and its result is replicated.  An op that
    fails on the gathered values too raises its own error.

    Anything that still fails raises its own error.  Both ways of giving
    up a shard are counted by op (``counts()``: ``gathered_views``,
    ``replicated_ops``), and an op run replicated warns once, since it
    then does its whole work on every rank."""

    def __init__(self):
        super().__init__()
        self.gathered_views = collections.Counter()
        self.replicated_ops = collections.Counter()

    def counts(self) -> dict:
        """{"gathered_views": {op: gathers a refused view took},
        "replicated_ops": {op: calls run on gathered values}}."""
        return {"gathered_views": dict(sorted(self.gathered_views.items())),
                "replicated_ops": dict(sorted(self.replicated_ops.items()))}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not (args and isinstance(args[0], DTensor)):
            return func(*args, **kwargs)
        if func in _VIEWS:
            x = args[0]
            while True:
                try:
                    return func(x, *args[1:], **kwargs)
                except RuntimeError:
                    shards = [i for i, p in enumerate(x.placements)
                              if _is_shard(p)]
                    if not shards:
                        raise
                self.gathered_views[str(func)] += 1
                placements = list(x.placements)
                placements[shards[-1]] = Replicate()
                try:
                    x = x.redistribute(x.device_mesh, placements)
                except RuntimeError:    # a strided shard DTensor cannot
                    x = x.redistribute(  # take apart one mesh dim at a time
                        x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        if func is _aten.index_put_.default:
            return _index_put(*args)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, IndexError):  # NotImplementedError included
            if func._schema.is_mutable or func.is_view:
                raise
        self.replicated_ops[str(func)] += 1
        warnings.warn(f"sharded: {func} runs on gathered values, "
                      f"replicated on every rank", stacklevel=2)
        mesh = args[0].device_mesh
        args, kwargs = tree_map_only(DTensor, lambda t: t.full_tensor(),
                                     (args, kwargs))
        return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False),
            func(*args, **kwargs))


class _Pin(torch.autograd.Function):
    """``h`` redistributed to ``placements``, and its gradient too: the
    gradient reaching a block boundary from the next block's row-parallel
    products, or from the unembedding, is a partial sum, and DTensor
    would carry it on and gather the weights of every product it meets
    (Megatron's "f" and "g" operators, both ways at once)."""

    @staticmethod
    def forward(ctx, h, placements):
        ctx.placements = placements
        return h.redistribute(h.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def _residual(mesh):
    """The residual stream's placement function (``models.transformer.
    RESIDUAL_SHARDING``): [B, S, D] with its batch over the data axes
    where it divides, replicated over the rest, in the forward and in
    the backward."""
    def place(h):
        if not isinstance(h, DTensor):
            return h
        return _Pin.apply(h, to_placements(frontend_spec(mesh, h.shape[0]),
                                           mesh))
    return place


def _index_put(t: DTensor, indices, values, *rest) -> DTensor:
    """``t[indices] = values`` in place on a DTensor (a cache write):
    on each rank's own shard when no indexed dim of ``t`` is sharded
    (the values placed as ``t``), else on the gathered tensor, copied
    back into ``t``'s placements (a KV cache's rows over "data" in the
    sequence-sharded decode)."""
    mesh = t.device_mesh
    idx = [None if i is None else full(i) for i in indices]
    # the shape of t[idx]: the index tensors' broadcast shape in their
    # place when they are adjacent, first when they are not
    at = [d for d, i in enumerate(idx) if i is not None]
    cut = torch.broadcast_shapes(*(idx[d].shape for d in at))
    rest_dims = [t.shape[d] for d in range(t.dim()) if d not in at]
    target = (tuple(t.shape[:at[0]]) + tuple(cut) + tuple(t.shape[at[-1] + 1:])
              if at == list(range(at[0], at[-1] + 1))
              else tuple(cut) + tuple(rest_dims))
    sharded_dims = {p.dim for p in t.placements if _is_shard(p)}
    if (len(target) == t.dim()
            and not any(idx[d] is not None for d in sharded_dims
                        if d < len(idx))):
        values = values.expand(target)
        values = (values.redistribute(mesh, t.placements)
                  if isinstance(values, DTensor)
                  else _place(values, mesh, t.placements))
        _aten.index_put_.default(t.to_local(), idx, values.to_local(), *rest)
        return t
    whole = t.full_tensor()
    _aten.index_put_.default(whole, idx, full(values), *rest)
    return t.copy_(_place(whole, mesh, t.placements))


@contextlib.contextmanager
def sharded(mesh):
    """The context of a sharded step: plain tensors count as replicated
    DTensors (``implicit_replication``), what DTensor refuses is
    resharded (``_Reshard``), the residual stream is pinned between
    blocks (``_residual``) and MoE layers follow ``MoESharding(mesh)``;
    all are undone on exit.  Yields the ``_Reshard`` mode, whose
    ``counts()`` say which ops gave up a shard."""
    tokens = (moe.ACTIVATION_SHARDING.set(MoESharding(mesh)),
              tfm.RESIDUAL_SHARDING.set(_residual(mesh)))
    try:
        with implicit_replication(), _Reshard() as reshard:
            yield reshard
    finally:
        moe.ACTIVATION_SHARDING.reset(tokens[0])
        tfm.RESIDUAL_SHARDING.reset(tokens[1])
