"""The decoder LM of every configuration, ported from
``repro.models.transformer``: attention, MLA, SSD and RG-LRU layers,
dense or MoE, alone or mixed in one stack, the prefix-LM and the
encoder-decoder.

One pre-norm residual stack: per layer, as ``cfg.block_kinds[i]`` says,
GQA attention (``attn``) or sliding-window attention (``local_attn``, a
ring cache of ``window`` rows) with partial rotary on interleaved
pairs, Multi-head Latent Attention (``mla``, ``models.mla``), the
Mamba-2 SSD block (``ssd``, ``models.ssd``) or the RG-LRU block
(``rglru``, ``models.rglru``); in an encoder-decoder, cross-attention
over the encoder's rows (``xattn``); then the channel mix: the MoE FFN
(``models.moe``) when ``cfg.n_experts`` > 0, else a dense one (SwiGLU
with SiLU or tanh-GELU, or the biased GELU MLP) when ``d_ff`` > 0; a
final norm and a tied or untied unembedding.  ``forward`` returns the
MoE layers' summed load-balance loss beside the logits, as the
reference does; the other modes discard it, as the reference's do.  The
modes share the layer code, as in the reference:

  - ``forward``      full sequence, no cache
  - ``prefill``      full sequence, writes the decode cache
  - ``decode_step``  one token per row against the cache, at a scalar
                     position (lockstep) or a [B] one (continuous)
  - ``decode_chunk`` n tokens per row at per-row positions, written
                     without ring wrap (the speculative verify)

A prefix-LM (paligemma) takes ``prefix_embeds`` [B, P, D] in
``forward`` and ``prefill``: they are put before the token embeddings,
positions < P see each other both ways (``cfg.prefix_lm``), and the
logits of the prefix rows are cut off.  An encoder-decoder (whisper)
takes ``enc_embeds`` [B, Senc, D] in the same two modes: ``encode`` runs
the bidirectional encoder (sinusoidal positions, no mask, no rotary),
``compute_cross_kv`` projects its output to every decoder layer's cross
K/V, which ``prefill`` puts on the cache (``cross_k`` / ``cross_v``
[L, B, Senc, K, hd]) for ``decode_step`` to read.

Attention dispatch (``attn_impl``, the reference's
``transformer.py:294-296`` rule): on a CUDA tensor ``"auto"`` takes the
hand-written kernels (flash attention for prefill and forward,
flash-decode for a decode step), which raise on a card that is not
sm_90; on a CPU tensor ``"auto"`` takes the model's einsum path,
bitwise equal to ``"xla"``, as the reference does off the TPU;
``"ref"`` takes the kernels' plain versions and ``"cuda"`` forces the
kernels.  A prefix batch (P > 0) stays on the einsum path whatever the
flag, as the reference's prefix mask does; a text-only batch of the
same model takes the kernels.  The encoder and the cross-attention are
einsum everywhere, as the reference's.  A verify chunk takes the
flash-decode body's chunk entry on the card, each query row attending
as a decode step at its position, and ``chunk_attend`` on the einsum
path.  The same field and rule route an SSD layer's chunked scan: the
CUDA SSD kernel on the card, the model's own chunked algorithm on the
CPU under ``"auto"`` and ``"xla"``; a decode step's single-step state
update is plain PyTorch everywhere, and so is the RG-LRU (the reference
runs no kernel there either).

No kernel has a backward, and the reference defines none: its train
step differentiates the einsum attention and the model's chunked SSD
algorithm.  So a full-sequence call whose layer needs a gradient (grad
mode on, and its input or one of its parameters requiring grad, as in
``training.train_loop``'s step) takes the einsum / chunked path under
``"auto"`` on the card too, ``"ref"`` its differentiable plain
versions, and ``"cuda"`` forced raises: no kernel output reaches a loss
without its gradient.  ``forward``, ``encode`` and
``compute_cross_kv`` therefore run under the caller's grad mode; the
parameters are frozen (``models.nn.param``), so serving builds no
graph.  Remat follows the reference's (``transformer.py:437-446``): in
``forward``, with grad on, when ``cfg.remat`` and ``cfg.remat_policy``
is not ``"none"``, each layer runs under ``torch.utils.checkpoint``
(non-reentrant); ``"full"`` recomputes the whole layer in the backward,
``"dots"`` saves the outputs of the products without batch dimensions
(``aten.mm`` / ``addmm``, not the attention's ``bmm``), the counterpart
of ``dots_with_no_batch_dims_saveable``, and recomputes the rest.

Parameters keep the reference's names and shapes, one module per layer
(the reference stacks a homogeneous stack's leaves ``[L, ...]`` and its
encoder's and cross-attention's; ``convert.lm_from_numpy`` unstacks
them).  Weights are ``cfg.dtype``, norms f32.

The cache (``Cache``) is written in place and keeps ONE stacked tensor
per kind of layer state, with a map from each layer to its kind and
its index in that stack, so a stack that mixes kinds still has a few
tensors, not one per layer: attention layers k/v [La, B, C, K, hd] and
pos [La, B, C] (C = min(max_seq, window) when every attention layer is
windowed: a ring), MLA layers their latent c_kv [Lm, B, C, r] and
k_rope [Lm, B, C, rope] with pos, SSD layers conv [Ls, B, W-1, ch] and
h [Ls, B, H, hd, N], RG-LRU layers lru_h [Lr, B, R] and lru_conv
[Lr, B, W-1, R] (recurrent states f32 whatever the cache dtype).  The
paged layout (``init_cache(layout="paged")``, a homogeneous ``attn``
stack only, as the reference's) stacks one pool per layer, k/v
[L, NB, bs, K, hd] with pos [L, B, C] and one block table [B, MB]
shared by every layer; it is decode-only: a prompt is prefilled into a
contiguous row cache and scattered into the pool
(``serving.continuous.paged_slot_write``).  ``forward`` starts every
recurrent layer from a zero state, as the reference's ``full`` mode.

The refusals are the reference's own: the paged layout on anything but
a homogeneous attention stack, ``decode_chunk`` on a stack that is not
pure attention or is an encoder-decoder, and ``draft_prefix`` on a
stack that mixes kinds.
"""
from __future__ import annotations

import contextvars
import copy
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models import nn as nn_
from repro_torch.models import rglru
from repro_torch.models import ssd
from repro_torch.models.nn import param

# the cache state each layer kind keeps: attention rows, an MLA latent,
# an SSD state or an RG-LRU state
STATE_OF = {"attn": "kv", "local_attn": "kv", "mla": "latent", "ssd": "ssd",
            "rglru": "rglru"}


# under a mesh (``launch.sharding.sharded`` sets and resets it), the
# function that places the residual stream [B, S, D] between blocks: its
# batch over the data axes, replicated over "model".  DTensor chooses
# each op's placements alone, and without a fixed point it carries
# partial sums and a feature-sharded stream into the next block's
# products, whose weights it then gathers whole; pinned here, each
# block runs Megatron's pattern (column-parallel in, row-parallel out,
# one all-reduce), which XLA's propagation reaches for the reference
RESIDUAL_SHARDING: contextvars.ContextVar = contextvars.ContextVar(
    "residual_sharding", default=None)


def _pin(h: torch.Tensor) -> torch.Tensor:
    place = RESIDUAL_SHARDING.get()
    return h if place is None else place(h)


# the products a "dots" remat saves: those without batch dimensions
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for a remat policy: the default
    (save nothing inside the layer) for ``"full"``, the selective policy
    for ``"dots"``."""
    if policy == "full":
        return noop_context_fn
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise ValueError(f"unknown remat policy {policy!r}")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def mla_config(cfg: ModelConfig) -> mla.MLAConfig:
    return mla.MLAConfig(
        n_heads=cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta)


def layer_index(cfg: ModelConfig) -> tuple[tuple[str, int], ...]:
    """Each layer's (state kind, index in that kind's stacked tensors)."""
    counts: dict[str, int] = {}
    out = []
    for kind in cfg.block_kinds:
        s = STATE_OF[kind]
        out.append((s, counts.get(s, 0)))
        counts[s] = counts.get(s, 0) + 1
    return tuple(out)


def kv_rows(cfg: ModelConfig, max_seq: int) -> int:
    """Rows of the attention layers' cache: a ring of ``window`` rows
    when every attention layer is windowed, else ``max_seq``."""
    kinds = {k for k in cfg.block_kinds if STATE_OF[k] == "kv"}
    return min(max_seq, cfg.window) if kinds == {"local_attn"} else max_seq


def paged_geometry(cfg: ModelConfig, batch: int,
                   max_seq: int) -> tuple[int, int, int]:
    """(blocks_per_slot, logical_len, pool_blocks) of a paged cache:
    ``cfg.kv_pool_blocks`` when set, else capacity parity with the
    contiguous layout (every slot maps its full extent) plus the trash
    block 0."""
    bs = cfg.kv_block_size
    if bs <= 0:
        raise ValueError(
            "paged cache geometry needs cfg.kv_block_size > 0 "
            f"(got {bs}) — set it, or use the contiguous layout")
    mb = -(-max_seq // bs)
    nb = cfg.kv_pool_blocks or (batch * mb + 1)
    return mb, mb * bs, nb


def _check_paged_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.block_kinds)
    if kinds != {"attn"} or cfg.family == "encdec":
        raise ValueError(
            f"paged KV pool (kv_block_size={cfg.kv_block_size}) only "
            f"supports homogeneous full-attention stacks; got block "
            f"kinds {sorted(kinds)} (family={cfg.family!r}).  Windowed "
            f"ring caches and recurrent states are constant-size per "
            f"slot already — run them on the contiguous layout.")


class Layer(nn.Module):
    """One residual block of kind ``kind``: ``norm1``, ``mix``
    (attention, MLA, the SSD block or the RG-LRU block), and the channel
    mix ``norm2`` + ``moe`` for an MoE config, else ``norm2`` + ``mlp``
    when ``cfg.d_ff`` > 0 (the reference's ``init_layer`` keys)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg.dtype)
        self.kind = kind
        self.window = cfg.window if kind == "local_attn" else 0
        self.norm1 = nn_.norm(cfg.norm, d, device=device)
        if kind == "ssd":
            self.mix = ssd.SSDParams(d, expand=cfg.ssm_expand,
                                     headdim=cfg.ssm_headdim,
                                     d_state=cfg.ssm_state,
                                     conv_width=cfg.ssm_conv, device=device,
                                     dtype=dt)
        elif kind == "rglru":
            self.mix = rglru.RGLRUParams(d, cfg.lru_width or d,
                                         cfg.conv_width, device=device,
                                         dtype=dt)
        elif kind == "mla":
            self.mix = mla.MLAParams(d, mla_config(cfg), device=device,
                                     dtype=dt)
        elif kind in ("attn", "local_attn"):
            self.mix = attn.AttnParams(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, bias=cfg.qkv_bias,
                                       device=device, dtype=dt)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.mlp = self.moe = None
        if cfg.is_moe:
            self.norm2 = nn_.norm(cfg.norm, d, device=device)
            self.moe = moe.MoEParams(d, cfg.n_experts, cfg.d_ff_expert,
                                     device=device, dtype=dt)
        elif cfg.d_ff:
            self.norm2 = nn_.norm(cfg.norm, d, device=device)
            if cfg.act == "gelu_mlp":
                self.mlp = nn_.MLP(d, cfg.d_ff, device=device, dtype=dt)
            else:
                self.mlp = nn_.SwiGLU(d, cfg.d_ff, act=cfg.act,
                                      device=device, dtype=dt)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.norm1, getattr(self, "norm2", None)):
            if m is not None:
                m.reset_parameters()
        self.mix.reset_parameters(gen)
        for m in (self.mlp, self.moe):
            if m is not None:
                m.reset_parameters(gen)


class EncoderLayer(nn.Module):
    """A whisper-style encoder block (ref ``_init_encoder``): ``norm1``,
    bidirectional attention ``mix``, ``norm2`` and the biased GELU
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, d: int, *, device=None):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.norm1 = nn_.norm(cfg.norm, d, device=device)
        self.mix = attn.AttnParams(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, bias=cfg.qkv_bias,
                                   device=device, dtype=dt)
        self.norm2 = nn_.norm(cfg.norm, d, device=device)
        self.mlp = nn_.MLP(d, cfg.d_ff, device=device, dtype=dt)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.mix.reset_parameters(gen)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(gen)


class Encoder(nn.Module):
    """The encoder over (stubbed) frame embeddings: ``layers`` and
    ``final_norm`` (ref ``params["encoder"]``)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.enc_d_model or cfg.d_model
        self.layers = nn.ModuleList(EncoderLayer(cfg, d, device=device)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = nn_.norm(cfg.norm, d, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(gen)
        self.final_norm.reset_parameters()


class CrossAttn(nn.Module):
    """One decoder layer's cross-attention: ``norm`` and ``mix`` (ref
    ``_init_xattn``)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.norm = nn_.norm(cfg.norm, cfg.d_model, device=device)
        self.mix = attn.AttnParams(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, bias=cfg.qkv_bias,
                                   device=device,
                                   dtype=torch_dtype(cfg.dtype))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm.reset_parameters()
        self.mix.reset_parameters(gen)


class Cache:
    """The decode cache, written in place: one stacked tensor per kind of
    layer state and ``index``, each layer's (kind, index in its stack).
    Attention layers hold k/v [La, B, C, K, hd] and pos [La, B, C] int32
    (-1 = empty); a paged pool holds k/v [L, NB, bs, K, hd] and
    ``block_table`` [B, MB] int32 (None on the contiguous layout).  MLA
    layers hold their latent, c_kv [Lm, B, C, r] and k_rope [Lm, B, C,
    rope], with pos.  SSD layers hold conv [Ls, B, W-1, ch] and h [Ls, B,
    H, hd, N]; RG-LRU layers lru_h [Lr, B, R] and lru_conv [Lr, B, W-1,
    R]; both f32.  An encoder-decoder's cross K/V are cross_k / cross_v
    [L, B, Senc, K, hd].  ``length`` is the number of tokens consumed (a
    device scalar after a continuous step, so reading it costs no host
    sync).  Without ``index`` the cache is one homogeneous stack of
    whichever state is given."""

    # leaves [L, B, C, ...] whose rows a prompt fills from row 0
    ROWS = ("k", "v", "c_kv", "k_rope")
    # leaves [L, B, ...] a slot holds whole
    STATES = ("conv", "h", "lru_h", "lru_conv", "cross_k", "cross_v")

    def __init__(self, k=None, v=None, pos=None, length=0,
                 block_table: torch.Tensor | None = None, *, conv=None,
                 h=None, c_kv=None, k_rope=None, lru_h=None, lru_conv=None,
                 cross_k=None, cross_v=None, index=None):
        self.k, self.v, self.pos, self.length = k, v, pos, length
        self.block_table = block_table
        self.conv, self.h = conv, h
        self.c_kv, self.k_rope = c_kv, k_rope
        self.lru_h, self.lru_conv = lru_h, lru_conv
        self.cross_k, self.cross_v = cross_k, cross_v
        if index is None:
            kind, lead = next((s, t) for s, t in (
                ("ssd", h), ("latent", c_kv), ("rglru", lru_h), ("kv", k))
                if t is not None)
            index = tuple((kind, i) for i in range(lead.shape[0]))
        self.index = tuple(index)

    @property
    def latent(self) -> bool:
        return self.c_kv is not None

    @property
    def cross(self):
        """The encoder-decoder's (cross_k, cross_v), or None."""
        return None if self.cross_k is None else (self.cross_k, self.cross_v)

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every per-slot tensor by name (pos included, the block table
        not)."""
        return {n: t for n in (*self.ROWS, "pos", *self.STATES)
                if (t := getattr(self, n)) is not None}

    def layer(self, i: int):
        """Layer i's views: an ``attn.KVCache``, an ``mla.MLACache``, an
        ``ssd.SSDState`` or an ``rglru.RGLRUState``."""
        kind, j = self.index[i]
        if kind == "ssd":
            return ssd.SSDState(conv=self.conv[j], h=self.h[j])
        if kind == "rglru":
            return rglru.RGLRUState(h=self.lru_h[j], conv=self.lru_conv[j])
        if kind == "latent":
            return mla.MLACache(c_kv=self.c_kv[j], k_rope=self.k_rope[j],
                                pos=self.pos[j])
        return attn.KVCache(k=self.k[j], v=self.v[j], pos=self.pos[j])

    @property
    def n_slots(self) -> int:
        t = self.pos if self.pos is not None else next(
            iter(self.leaves().values()))
        return t.shape[1]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda",
               layout: str = "auto") -> Cache:
    """Decode cache for ``batch`` slots of up to ``max_seq`` tokens,
    bf16 by default as the reference (``transformer.py:211``).
    ``layout="auto"`` follows ``cfg.kv_block_size`` (paged when > 0);
    ``"contiguous"`` / ``"paged"`` force it (the continuous engine
    prefills contiguous ROW caches even when its pool is paged).  A
    windowed stack keeps a ring of ``window`` rows.  SSD and RG-LRU
    states are f32 whatever ``dtype``, and their size does not depend on
    ``max_seq``; an MLA latent and an encoder-decoder's cross K/V are
    ``dtype``, as the reference's (``transformer.py:159, 246``)."""
    return _build_cache(cfg, batch, max_seq, dtype, resolve_device(device),
                        layout)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> Cache:
    """``init_cache``'s contiguous cache on the meta device: shapes and
    dtypes without memory (the dry run's; ``init_cache`` itself takes
    the card or the CPU only)."""
    return _build_cache(cfg, batch, max_seq, dtype, torch.device("meta"),
                        "contiguous")


def _build_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                 dev: torch.device, layout: str) -> Cache:
    if layout not in ("auto", "contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    K, hd = cfg.n_kv_heads, cfg.head_dim
    if cfg.paged_kv if layout == "auto" else layout == "paged":
        _check_paged_supported(cfg)
        L = cfg.n_layers
        mb, logical, nb = paged_geometry(cfg, batch, max_seq)
        bs = cfg.kv_block_size
        return Cache(
            k=torch.zeros(L, nb, bs, K, hd, dtype=dtype, device=dev),
            v=torch.zeros(L, nb, bs, K, hd, dtype=dtype, device=dev),
            pos=torch.full((L, batch, logical), -1, dtype=torch.int32,
                           device=dev),
            block_table=torch.zeros(batch, mb, dtype=torch.int32,
                                    device=dev))
    index = layer_index(cfg)
    n = {s: sum(1 for k, _ in index if k == s)
         for s in ("kv", "latent", "ssd", "rglru")}
    out = {}
    if n["kv"]:
        C = kv_rows(cfg, max_seq)
        out.update(
            k=torch.zeros(n["kv"], batch, C, K, hd, dtype=dtype, device=dev),
            v=torch.zeros(n["kv"], batch, C, K, hd, dtype=dtype, device=dev),
            pos=torch.full((n["kv"], batch, C), -1, dtype=torch.int32,
                           device=dev))
    if n["latent"]:
        lat = mla.init_mla_cache(n["latent"] * batch, max_seq,
                                 mla_config(cfg), dtype, device=dev)
        out.update(c_kv=lat.c_kv.reshape(n["latent"], batch, max_seq, -1),
                   k_rope=lat.k_rope.reshape(n["latent"], batch, max_seq,
                                             -1),
                   pos=lat.pos.reshape(n["latent"], batch, max_seq))
    if n["ssd"]:
        st = ssd.ssd_state_zeros(n["ssd"] * batch, cfg.d_model,
                                 expand=cfg.ssm_expand,
                                 headdim=cfg.ssm_headdim,
                                 d_state=cfg.ssm_state,
                                 conv_width=cfg.ssm_conv, dev=dev)
        out.update(conv=st.conv.reshape(n["ssd"], batch, *st.conv.shape[1:]),
                   h=st.h.reshape(n["ssd"], batch, *st.h.shape[1:]))
    if n["rglru"]:
        st = rglru.rglru_state_zeros(n["rglru"] * batch,
                                     cfg.lru_width or cfg.d_model,
                                     cfg.conv_width, dev=dev)
        out.update(lru_h=st.h.reshape(n["rglru"], batch, -1),
                   lru_conv=st.conv.reshape(n["rglru"], batch,
                                            *st.conv.shape[1:]))
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.enc_seq, K, hd)
        out.update(cross_k=torch.zeros(shape, dtype=dtype, device=dev),
                   cross_v=torch.zeros(shape, dtype=dtype, device=dev))
    return Cache(index=index, **out)


class LM(nn.Module):
    """The LM; ``attn_impl`` starts as ``cfg.attn_impl`` and may be
    switched on a built model (the parity checks do)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = cfg.attn_impl
        d, V, dt = cfg.d_model, cfg.vocab, torch_dtype(cfg.dtype)
        self.emb = param(V, d, device=device, dtype=dt)
        self.final_norm = nn_.norm(cfg.norm, d, device=device)
        if not cfg.tie_embeddings:
            self.unemb = param(d, V, device=device, dtype=dt)
        self.layers = nn.ModuleList(Layer(cfg, kind, device=device)
                                    for kind in cfg.block_kinds)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, device=device)
            self.xattn = nn.ModuleList(CrossAttn(cfg, device=device)
                                       for _ in range(cfg.n_layers))
        kinds = set(cfg.block_kinds)
        # rotary tables only where a layer attends; MLA rotates only the
        # rope part of q and k, over all of it
        self.has_rope = bool(kinds & {"attn", "local_attn", "mla"})
        self.rotary_dim = (cfg.qk_rope_dim if "mla" in kinds
                           else int(cfg.head_dim * cfg.rope_pct))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn_.embed_init_(self.emb, gen)
        self.final_norm.reset_parameters()
        if not self.cfg.tie_embeddings:
            nn_.dense_init_(self.unemb, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        if self.cfg.family == "encdec":
            self.encoder.reset_parameters(gen)
            for xa in self.xattn:
                xa.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    # -- pieces ---------------------------------------------------------------
    def _use_kernel(self, x: torch.Tensor, layer: nn.Module) -> bool:
        """Whether ``layer``'s temporal mix on ``x`` goes through the
        kernel dispatch: never under ``"xla"``, on a CUDA tensor under
        ``"auto"``; and, when the layer needs a gradient, only under
        ``"ref"`` (plain, differentiable versions), while ``"cuda"``
        raises (the module docstring says why)."""
        impl = self.attn_impl
        if impl == "xla" or (impl == "auto" and x.device.type != "cuda"):
            return False
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad
            or any(p.requires_grad for p in layer.mix.parameters()))
        if needs_grad and impl == "cuda":
            raise ValueError(
                'attn_impl="cuda" with grad enabled: the CUDA kernels have '
                'no backward; train with attn_impl="auto" (the einsum and '
                'chunked paths) or "xla"')
        return not needs_grad or impl == "ref"

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.emb[tokens]
        if self.cfg.scale_embeddings:
            h = h * torch.tensor(self.cfg.d_model ** 0.5, dtype=h.dtype)
        return h

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        if self.cfg.tie_embeddings:
            return h @ self.emb.T
        return h @ self.unemb

    def _rope(self, positions: torch.Tensor):
        if not self.has_rope:        # no attention, so no rotary tables
            return None
        return nn_.rope_angles(positions, self.rotary_dim,
                               self.cfg.rope_theta)

    def _attn(self, layer: Layer, x, *, mode, kv, rope, pos=None, cur=None,
              table=None, rows=None, prefix_len: int = 0):
        """Temporal mixing: projections, rotary, attention through the
        kernels or the einsum path, and the cache write (into the paged
        pool through ``table`` at the step's ``rows`` when they are
        given; the step has written ``pos`` already).  ``chunk`` mode
        writes S rows per slot from ``cur`` without ring wrap and attends
        through the chunk entry.  A
        prefix batch (``prefix_len`` > 0) attends on the einsum path
        with the prefix-LM mask."""
        cfg, p, window = self.cfg, layer.mix, layer.window
        q, k, v = attn.project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim)
        q = nn_.rotate(q, *rope)
        k = nn_.rotate(k, *rope)
        kernel = self._use_kernel(x, layer) and prefix_len == 0
        if mode in ("full", "prefill"):
            if kernel:
                o = attn.causal_attention_kernel(q, k, v, window=window,
                                                 impl=self.attn_impl)
            elif window and x.shape[1] > window:
                o = attn.local_attention(q, k, v, window=window)
            else:
                o = attn.causal_attention(q, k, v, window=window,
                                          prefix_len=prefix_len)
            if mode == "prefill":
                attn.cache_write(kv, k, v, 0)
        elif mode == "chunk":
            attn.cache_write_chunk(kv, k, v, cur)
            if kernel:
                o = attn.chunk_attend_kernel(q, kv, start=cur, window=window,
                                             impl=self.attn_impl)
            else:
                o = attn.chunk_attend(q, kv, qpos=pos, window=window)
        elif table is not None:
            attn.paged_write_rows(kv.k, kv.v, k, v, rows)
            if kernel:
                o = attn.paged_decode_attend_kernel(q, kv, table, pos=cur,
                                                    window=window,
                                                    impl=self.attn_impl)
            else:
                o = attn.paged_decode_attend(q, kv, table, pos=pos,
                                             window=window)
        else:
            attn.cache_write(kv, k, v, pos)
            if kernel:
                o = attn.decode_attend_kernel(q, kv, pos=cur, window=window,
                                              impl=self.attn_impl)
            else:
                o = attn.decode_attend(q, kv, pos=pos, window=window)
        return attn.out_proj(p, o)

    def _mla(self, layer: Layer, x, *, mode, lc, rope, pos):
        """Temporal mixing of an MLA layer (ref ``_mla_mix``,
        ``transformer.py:363-373``): the expanded form for ``forward``
        and prefill (whose latents go to the cache from position 0), the
        absorbed decode for a step.  ``decode_chunk`` refuses MLA before
        it gets here, as the reference's does."""
        if mode == "full":
            return mla.mla_attention(layer.mix, x, rope=rope)
        if mode == "prefill":
            return mla.mla_prefill(layer.mix, lc, x, rope=rope)
        return mla.mla_decode(layer.mix, x, lc, pos=pos, rope=rope)[0]

    def _channel(self, layer: Layer, h, need_aux: bool):
        """The channel mix (ref ``_channel_mix``, ``transformer.py:
        255-270``): the MoE FFN, with its load-balance loss when
        ``need_aux``, or the dense MLP, or nothing; -> (h, aux or None)."""
        if layer.moe is not None:
            cfg = self.cfg
            y, a = moe.moe_forward(layer.moe, layer.norm2(h), top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   need_aux=need_aux)
            return h + y, a if need_aux else None
        if layer.mlp is not None:
            return h + layer.mlp(layer.norm2(h)), None
        return h, None

    def _ssd(self, layer: Layer, x, *, mode, state):
        """Temporal mixing of an SSD layer: the chunked scan (through
        the kernel dispatch on ``attn_impl``'s rule) for prefill and
        forward, the single-step update for decode; ``state`` (None in
        ``full`` mode) is updated in place."""
        impl = self.attn_impl if self._use_kernel(x, layer) else None
        return ssd.ssd_block(layer.mix, x, state, chunk=self.cfg.ssm_chunk,
                             single_step=mode == "decode", impl=impl)

    def _stack(self, h, *, mode, cache=None, rope, pos=None, cur=None,
               aux: list | None = None, prefix_len: int = 0, cross=None):
        table = cache.block_table if cache is not None else None
        rows = None
        if table is not None and mode == "decode":
            # one step's rows, located once: the block size is the pool's
            # own (a model built without paging serves any pool), and pos
            # is written for every layer in one go
            rows = attn.paged_locate(table, pos, cache.k.shape[2],
                                     cache.pos.shape[2])
            attn.paged_write_pos(cache.pos, rows)
        cfg = self.cfg
        remat = (mode == "full" and cfg.remat and cfg.remat_policy != "none"
                 and torch.is_grad_enabled())
        for i in range(len(self.layers)):
            h = _pin(h)
            kw = dict(mode=mode, lc=cache.layer(i) if cache is not None
                      else None, rope=rope, pos=pos, cur=cur, table=table,
                      rows=rows, prefix_len=prefix_len, cross=cross,
                      need_aux=aux is not None)
            if remat:
                h, a = checkpoint(
                    self._layer, i, h, use_reentrant=False,
                    context_fn=_remat_context(cfg.remat_policy), **kw)
            else:
                h, a = self._layer(i, h, **kw)
            if a is not None:
                aux.append(a)
        return _pin(h)

    def _layer(self, i: int, h, *, mode, lc=None, rope=None, pos=None,
               cur=None, table=None, rows=None, prefix_len: int = 0,
               cross=None, need_aux: bool = False):
        """Layer i on h: the temporal mix, the cross-attention of an
        encoder-decoder, the channel mix; -> (h, the MoE aux or None)."""
        cfg, layer = self.cfg, self.layers[i]
        x = layer.norm1(h)
        if layer.kind == "ssd":
            h = h + self._ssd(layer, x, mode=mode, state=lc)
        elif layer.kind == "rglru":
            h = h + rglru.rglru_block(layer.mix, x, lc,
                                      single_step=mode == "decode")
        elif layer.kind == "mla":
            h = h + self._mla(layer, x, mode=mode, lc=lc, rope=rope, pos=pos)
        else:
            h = h + self._attn(layer, x, mode=mode, kv=lc, rope=rope,
                               pos=pos, cur=cur, table=table, rows=rows,
                               prefix_len=prefix_len)
        h = _pin(h)
        if cross is not None:
            xa = self.xattn[i]
            h = h + attn.cross_attend(xa.mix, xa.norm(h), cross[0][i],
                                      cross[1][i], cfg.n_heads, cfg.head_dim)
        return self._channel(layer, h, need_aux)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _inputs(self, tokens, prefix_embeds):
        """Token embeddings after the prefix embeddings (cast to the
        embeddings' dtype, as the reference); -> (h, P, the mask's
        prefix length: P on a prefix-LM, else 0)."""
        h = self.embed(self._tokens(tokens))
        if prefix_embeds is None:
            return h, 0, 0
        pre = torch.as_tensor(prefix_embeds, device=self.device)
        h = torch.cat([pre.to(h.dtype), h], dim=1)
        P = pre.shape[1]
        return h, P, P if self.cfg.prefix_lm else 0

    def _encoded_cross(self, enc_embeds):
        """An encoder-decoder's cross K/V from ``enc_embeds``; None for
        any other stack."""
        if self.cfg.family != "encdec":
            return None
        if enc_embeds is None:
            raise ValueError(
                f"{self.cfg.arch_id} is an encoder-decoder: forward and "
                f"prefill need enc_embeds [B, {self.cfg.enc_seq}, "
                f"{self.cfg.enc_d_model or self.cfg.d_model}]")
        return self.compute_cross_kv(self.encode(enc_embeds))

    # -- the encoder ----------------------------------------------------------
    def encode(self, enc_embeds) -> torch.Tensor:
        """The bidirectional encoder over frame embeddings [B, Senc, D]
        (ref ``encode``, ``transformer.py:528-548``): sinusoidal
        positions, then per layer all-visible attention (no rotary) and
        the GELU MLP, then the final norm.  The embeddings are taken in
        the weights' dtype (a torch product needs one type; the reference
        promotes bf16 weights against f32 embeddings instead)."""
        cfg = self.cfg
        x = torch.as_tensor(enc_embeds, device=self.device).to(self.emb.dtype)
        h = x + nn_.sinusoidal_positions(x.shape[1], x.shape[2],
                                         device=x.device).to(x.dtype)
        for lp in self.encoder.layers:
            h = _pin(h)
            q, k, v = attn.project_qkv(lp.mix, lp.norm1(h), cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim)
            h = _pin(h + attn.out_proj(lp.mix, attn.attend(q, k, v)))
            h = h + lp.mlp(lp.norm2(h))
        return self.encoder.final_norm(_pin(h))

    def compute_cross_kv(self, enc_out: torch.Tensor):
        """Every decoder layer's cross K/V from the encoder's output
        (ref ``compute_cross_kv``): (k, v), each [L, B, Senc, K, hd]."""
        cfg = self.cfg
        kv = [attn.cross_kv(xa.mix, enc_out, cfg.n_kv_heads, cfg.head_dim)
              for xa in self.xattn]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    # -- modes ----------------------------------------------------------------
    def forward(self, tokens, *, prefix_embeds=None, enc_embeds=None):
        """Full-sequence logits [B, S, V] of the tokens (the prefix rows
        cut off); returns (logits, aux_loss): the MoE layers'
        load-balance losses summed, f32 (0 without MoE)."""
        h, P, mask_prefix = self._inputs(tokens, prefix_embeds)
        cross = self._encoded_cross(enc_embeds)
        rope = self._rope(torch.arange(h.shape[1], device=self.device))
        aux = []
        h = self._stack(h, mode="full", rope=rope, aux=aux,
                        prefix_len=mask_prefix, cross=cross)
        logits = self.unembed(h)
        return logits[:, P:], (torch.stack(aux).sum() if aux else
                               torch.zeros((), device=self.device))

    @torch.no_grad()
    def prefill(self, tokens, cache: Cache, *, prefix_embeds=None,
                enc_embeds=None):
        """Consume the prompt (after ``prefix_embeds``, when given), fill
        the cache from position 0, and return (last-position logits
        [B, 1, V], cache).  An encoder-decoder encodes ``enc_embeds`` and
        puts the cross K/V on the cache (the computed tensors, as the
        reference's prefill returns them).  A paged pool is refused:
        prefill a contiguous row cache and scatter it."""
        if cache.block_table is not None:
            raise ValueError(
                "prefill into a paged pool is not supported — prefill a "
                "contiguous row cache and scatter it into the pool blocks "
                "(see repro_torch.serving.continuous.paged_slot_write)")
        h, _, mask_prefix = self._inputs(tokens, prefix_embeds)
        cross = self._encoded_cross(enc_embeds)
        if cross is not None:
            cache.cross_k, cache.cross_v = cross
        S = h.shape[1]
        rope = self._rope(torch.arange(S, device=self.device))
        h = self._stack(h, mode="prefill", cache=cache, rope=rope,
                        prefix_len=mask_prefix, cross=cross)
        cache.length = S
        return self.unembed(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token, cache: Cache, pos):
        """One token per row: token [B, 1]; ``pos`` its absolute position,
        an int (lockstep) or a [B] tensor (continuous batching).  Returns
        (logits [B, 1, V], cache)."""
        token = self._tokens(token)
        B = token.shape[0]
        h = self.embed(token)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            positions = pos[:, None]                       # [B, 1]
            cur = pos.to(torch.int32)
            cache.length = pos.max() + 1
        else:
            pos = int(pos)
            positions = torch.arange(pos, pos + 1, device=self.device)
            cur = torch.full((B,), pos, dtype=torch.int32,
                             device=self.device)
            cache.length = pos + 1
        h = self._stack(h, mode="decode", cache=cache,
                        rope=self._rope(positions), pos=pos, cur=cur,
                        cross=cache.cross)
        return self.unembed(h), cache

    @torch.no_grad()
    def decode_chunk(self, tokens, cache: Cache, pos):
        """Multi-token decode, the speculative-verify primitive (ref
        ``transformer.py:639-670``): ``tokens`` [B, n] are consumed at
        per-row absolute positions ``pos[b] .. pos[b]+n-1`` in ONE pass
        with causal intra-chunk attention, written by
        ``cache_write_chunk`` (clamped at the cache's last row, never
        wrapped); returns (logits [B, n, V], cache).  Row j's logits
        condition on what a decode step at ``pos + j`` would see.
        Contiguous attention stacks only, not encoder-decoders (an MoE
        channel mix routes the chunk's B*n tokens as one group)."""
        cfg = self.cfg
        kinds = set(cfg.block_kinds)
        if not kinds <= {"attn", "local_attn"} or cfg.family == "encdec":
            raise ValueError(
                f"decode_chunk needs a pure attention stack (attn / "
                f"local_attn); got kinds={sorted(kinds)} family={cfg.family}")
        if cache is None:
            raise ValueError("decode_chunk writes a decode cache; got None")
        if cache.block_table is not None:
            raise ValueError(
                "decode_chunk supports the contiguous KV layout only; run "
                "the paged pool with draft_depth == 0")
        tokens = self._tokens(tokens)
        B, n = tokens.shape
        start = torch.as_tensor(pos, device=self.device).long().expand(B)
        positions = start[:, None] + torch.arange(n, device=self.device)
        h = self.embed(tokens)
        h = self._stack(h, mode="chunk", cache=cache,
                        rope=self._rope(positions), pos=positions,
                        cur=start.to(torch.int32))
        cache.length = start.max() + n
        return self.unembed(h), cache

    def draft_prefix(self, n: int) -> "LM":
        """The self-speculative draft (ref ``transformer.py:673-690``):
        an ``LM`` over the FIRST ``n`` layers of this homogeneous stack,
        sharing the embedding, final norm and unembedding (shallow exit).
        No weight is copied: the view holds the same parameter tensors,
        and it runs against the full model's cache, whose first ``n``
        layers it reads and writes."""
        cfg = self.cfg
        if not cfg.homogeneous:
            raise ValueError(
                "self-speculative drafting slices a layer prefix, which "
                "needs a homogeneous stack")
        if not 0 < n < cfg.n_layers:
            raise ValueError(
                f"draft prefix must satisfy 0 < n < n_layers, got n={n} "
                f"with n_layers={cfg.n_layers}")
        view = copy.copy(self)
        view._modules = dict(self._modules)
        view.layers = nn.ModuleList(self.layers[:n])
        return view


def abstract_lm(cfg: ModelConfig) -> LM:
    """The model with its parameters on the meta device: every shape and
    dtype, no memory and no values (llama3-405b is 810 GB in bf16).  The
    dry run shards and steps it; ``init_lm`` takes the card or the CPU
    only."""
    return LM(cfg, device=torch.device("meta")).eval()


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """A model with weights drawn from ``torch.Generator(seed)`` on
    ``device`` (the card by default; other numbers than the reference's
    ``jax.random`` for the same seed, so parity tests carry the
    reference's weights across with ``convert.lm_from_numpy``)."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval()
