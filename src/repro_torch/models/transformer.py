"""Decoder LM for attention, MLA and SSD stacks, dense or MoE, ported
from ``repro.models.transformer``.

One pre-norm residual stack: per layer, GQA attention (``attn``) or
sliding-window attention (``local_attn``, a ring cache of ``window``
rows) with partial rotary on interleaved pairs, Multi-head Latent
Attention (``mla``, ``models.mla``) or the Mamba-2 SSD block (``ssd``,
``models.ssd``), then the channel mix: the MoE FFN (``models.moe``)
when ``cfg.n_experts`` > 0, else a dense one (SwiGLU with SiLU or
tanh-GELU, or the biased GELU MLP) when ``d_ff`` > 0; a final norm and
a tied or untied unembedding.  ``forward`` returns the MoE layers'
summed load-balance loss beside the logits, as the reference does; the
other modes discard it, as the reference's do.  Three modes share the layer
code, as in the reference:

  - ``forward``      full sequence, no cache
  - ``prefill``      full sequence, writes the decode cache
  - ``decode_step``  one token per row against the cache, at a scalar
                     position (lockstep) or a [B] one (continuous)
  - ``decode_chunk`` n tokens per row at per-row positions, written
                     without ring wrap (the speculative verify, and the
                     draft's steps through ``draft_prefix``)

Attention dispatch (``attn_impl``, the reference's
``transformer.py:294-296`` rule): on a CUDA tensor ``"auto"`` takes the
hand-written kernels (flash attention for prefill and forward,
flash-decode for a decode step), which raise on a card that is not
sm_90; on a CPU tensor ``"auto"`` takes the model's einsum path,
bitwise equal to ``"xla"``, as the reference does off the TPU;
``"ref"`` takes the kernels' plain versions and ``"cuda"`` forces the
kernels.  A verify chunk takes the flash-decode body's chunk entry on
the card, each query row attending as a decode step at its position,
and ``chunk_attend`` on the einsum path (the reference's, which off the
TPU shares step decode's numerics).  A prefix-LM batch would stay on
the einsum path.  The same
field and rule route an SSD stack's chunked scan (prefill and forward):
the CUDA SSD kernel on the card, the model's own chunked algorithm on
the CPU under ``"auto"`` and ``"xla"``; a decode step's single-step
state update is plain PyTorch everywhere.

Parameters keep the reference's names and shapes, one module per layer
(the reference stacks a homogeneous stack's leaves ``[L, ...]``;
``convert.lm_from_numpy`` unstacks them).  Weights are ``cfg.dtype``,
norms f32.  The cache is stacked, k/v [L, B, C, K, hd] and pos
[L, B, C], and is written in place.  The paged layout
(``init_cache(layout="paged")``, a homogeneous ``attn`` stack only)
stacks one pool per layer, k/v [L, NB, bs, K, hd] and pos [L, B, C],
with one block table [B, MB] on the cache shared by every layer; it is
decode-only, as the reference's: a prompt is prefilled into a
contiguous row cache and scattered into the pool
(``serving.continuous.paged_slot_write``).  An MLA stack's cache is its
latent, c_kv [L, B, C, r] and k_rope [L, B, C, rope] in the cache
dtype, with pos [L, B, C]; it has no paged layout, as the reference's.
An SSD stack's cache is its recurrent state, stacked and written in
place: conv [L, B, W-1, ch] and h [L, B, H, hd, N], both f32;
``forward`` starts from a zero state, as the reference's ``full``
mode.

Not in this slice, and raising with the slice that brings them: RG-LRU
layers, stacks that mix layer kinds, encoder-decoder and prefix-LM
models (the model-families slice).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models import nn as nn_
from repro_torch.models import ssd
from repro_torch.models.nn import param

FAMILIES_SLICE = "the model-families slice (ROADMAP queue 1 item 12)"


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not serve yet, naming the slice."""
    kinds = sorted(set(cfg.block_kinds)
                   - {"attn", "local_attn", "mla", "ssd"})
    if kinds:
        raise NotImplementedError(
            f"{cfg.arch_id}: layer kinds {kinds} come with {FAMILIES_SLICE}")
    if not cfg.homogeneous:
        raise NotImplementedError(
            f"{cfg.arch_id}: a stack mixing layer kinds "
            f"{sorted(set(cfg.block_kinds))} comes with {FAMILIES_SLICE}")
    if cfg.family == "encdec" or cfg.prefix_lm:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder and prefix-LM models come "
            f"with {FAMILIES_SLICE}")


def mla_config(cfg: ModelConfig) -> mla.MLAConfig:
    return mla.MLAConfig(
        n_heads=cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta)


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
    """One residual block: ``norm1``, ``mix`` (attention, MLA, or the
    SSD block), and the channel mix ``norm2`` + ``moe`` for an MoE
    config, else ``norm2`` + ``mlp`` when ``cfg.d_ff`` > 0 (the
    reference's ``init_layer`` keys)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg.dtype)
        kind = cfg.block_kinds[0]
        self.norm1 = nn_.norm(cfg.norm, d, device=device)
        if kind == "ssd":
            self.mix = ssd.SSDParams(d, expand=cfg.ssm_expand,
                                     headdim=cfg.ssm_headdim,
                                     d_state=cfg.ssm_state,
                                     conv_width=cfg.ssm_conv, device=device,
                                     dtype=dt)
        elif kind == "mla":
            self.mix = mla.MLAParams(d, mla_config(cfg), device=device,
                                     dtype=dt)
        else:
            self.mix = attn.AttnParams(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, bias=cfg.qkv_bias,
                                       device=device, dtype=dt)
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


class Cache:
    """The decode cache of a homogeneous stack, written in place.  An
    attention stack holds k/v [L, B, C, K, hd] and pos [L, B, C] int32
    (-1 = empty); a paged pool holds k/v [L, NB, bs, K, hd] and
    ``block_table`` [B, MB] int32 (None on the contiguous layout).  An
    MLA stack holds its latent, c_kv [L, B, C, r] and k_rope [L, B, C,
    rope], with pos, and no k/v.  An SSD stack holds its recurrent state
    instead, conv [L, B, W-1, ch] and h [L, B, H, hd, N] f32, and no
    k/v/pos.  ``length`` is the number of tokens consumed (a device
    scalar after a continuous step, so reading it costs no host sync)."""

    def __init__(self, k=None, v=None, pos=None, length=0,
                 block_table: torch.Tensor | None = None, *, conv=None,
                 h=None, c_kv=None, k_rope=None):
        self.k, self.v, self.pos, self.length = k, v, pos, length
        self.block_table = block_table
        self.conv, self.h = conv, h
        self.c_kv, self.k_rope = c_kv, k_rope

    @property
    def recurrent(self) -> bool:
        return self.h is not None

    @property
    def latent(self) -> bool:
        return self.c_kv is not None

    def layer(self, i: int):
        """Layer i's views: an ``attn.KVCache``, an ``mla.MLACache`` or an
        ``ssd.SSDState``."""
        if self.recurrent:
            return ssd.SSDState(conv=self.conv[i], h=self.h[i])
        if self.latent:
            return mla.MLACache(c_kv=self.c_kv[i], k_rope=self.k_rope[i],
                                pos=self.pos[i])
        return attn.KVCache(k=self.k[i], v=self.v[i], pos=self.pos[i])

    @property
    def n_slots(self) -> int:
        return (self.h if self.recurrent else self.pos).shape[1]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda",
               layout: str = "auto") -> Cache:
    """Decode cache for ``batch`` slots of up to ``max_seq`` tokens,
    bf16 by default as the reference (``transformer.py:211``).
    ``layout="auto"`` follows ``cfg.kv_block_size`` (paged when > 0);
    ``"contiguous"`` / ``"paged"`` force it (the continuous engine
    prefills contiguous ROW caches even when its pool is paged).  A
    windowed stack keeps a ring of ``window`` rows.  An SSD stack's
    state is f32 whatever ``dtype``, and its size does not depend on
    ``max_seq``; an MLA stack's latent is ``dtype``, as the reference's
    (``transformer.py:159``)."""
    if layout not in ("auto", "contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    check_supported(cfg)
    dev = resolve_device(device)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.paged_kv if layout == "auto" else layout == "paged":
        _check_paged_supported(cfg)
        mb, logical, nb = paged_geometry(cfg, batch, max_seq)
        bs = cfg.kv_block_size
        return Cache(
            k=torch.zeros(L, nb, bs, K, hd, dtype=dtype, device=dev),
            v=torch.zeros(L, nb, bs, K, hd, dtype=dtype, device=dev),
            pos=torch.full((L, batch, logical), -1, dtype=torch.int32,
                           device=dev),
            block_table=torch.zeros(batch, mb, dtype=torch.int32,
                                    device=dev))
    if cfg.block_kinds[0] == "ssd":
        st = ssd.init_ssd_state(L * batch, cfg.d_model,
                                expand=cfg.ssm_expand,
                                headdim=cfg.ssm_headdim,
                                d_state=cfg.ssm_state,
                                conv_width=cfg.ssm_conv, device=dev)
        return Cache(conv=st.conv.reshape(L, batch, *st.conv.shape[1:]),
                     h=st.h.reshape(L, batch, *st.h.shape[1:]))
    if cfg.block_kinds[0] == "mla":
        lat = mla.init_mla_cache(L * batch, max_seq, mla_config(cfg), dtype,
                                 device=dev)
        return Cache(c_kv=lat.c_kv.reshape(L, batch, max_seq, -1),
                     k_rope=lat.k_rope.reshape(L, batch, max_seq, -1),
                     pos=lat.pos.reshape(L, batch, max_seq))
    window = cfg.window if cfg.block_kinds[0] == "local_attn" else 0
    C = min(max_seq, window) if window else max_seq
    return Cache(
        k=torch.zeros(L, batch, C, K, hd, dtype=dtype, device=dev),
        v=torch.zeros(L, batch, C, K, hd, dtype=dtype, device=dev),
        pos=torch.full((L, batch, C), -1, dtype=torch.int32, device=dev))


class LM(nn.Module):
    """The decoder LM; ``attn_impl`` starts as ``cfg.attn_impl`` and may
    be switched on a built model (the parity checks do)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.attn_impl = cfg.attn_impl
        d, V, dt = cfg.d_model, cfg.vocab, torch_dtype(cfg.dtype)
        self.emb = param(V, d, device=device, dtype=dt)
        self.final_norm = nn_.norm(cfg.norm, d, device=device)
        if not cfg.tie_embeddings:
            self.unemb = param(d, V, device=device, dtype=dt)
        self.layers = nn.ModuleList(Layer(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        kind = cfg.block_kinds[0]
        self.recurrent = kind == "ssd"
        self.latent = kind == "mla"
        self.window = cfg.window if kind == "local_attn" else 0
        # MLA rotates only the rope part of q and k, over all of it
        self.rotary_dim = (cfg.qk_rope_dim if self.latent
                           else int(cfg.head_dim * cfg.rope_pct))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn_.embed_init_(self.emb, gen)
        self.final_norm.reset_parameters()
        if not self.cfg.tie_embeddings:
            nn_.dense_init_(self.unemb, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    # -- pieces ---------------------------------------------------------------
    def _use_kernel(self, x: torch.Tensor) -> bool:
        impl = self.attn_impl
        return impl != "xla" and (impl != "auto" or x.device.type == "cuda")

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
        if self.recurrent:        # no attention, so no rotary tables
            return None
        return nn_.rope_angles(positions, self.rotary_dim,
                               self.cfg.rope_theta)

    def _attn(self, layer: Layer, x, *, mode, kv, rope, pos=None, cur=None,
              table=None, rows=None):
        """Temporal mixing: projections, rotary, attention through the
        kernels or the einsum path, and the cache write (into the paged
        pool through ``table`` at the step's ``rows`` when they are
        given; the step has written ``pos`` already).  ``chunk`` mode
        writes S rows per slot from ``cur`` without ring wrap; one row
        attends as a decode step, more through the chunk entry."""
        cfg, p = self.cfg, layer.mix
        q, k, v = attn.project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim)
        q = nn_.rotate(q, *rope)
        k = nn_.rotate(k, *rope)
        kernel = self._use_kernel(x)
        if mode in ("full", "prefill"):
            if kernel:
                o = attn.causal_attention_kernel(q, k, v, window=self.window,
                                                 impl=self.attn_impl)
            elif self.window and x.shape[1] > self.window:
                o = attn.local_attention(q, k, v, window=self.window)
            else:
                o = attn.causal_attention(q, k, v, window=self.window)
            if mode == "prefill":
                attn.cache_write(kv, k, v, 0)
        elif mode == "chunk":
            attn.cache_write_chunk(kv, k, v, cur)
            if kernel and x.shape[1] == 1:
                o = attn.decode_attend_kernel(q, kv, pos=cur,
                                              window=self.window,
                                              impl=self.attn_impl)
            elif kernel:
                o = attn.chunk_attend_kernel(q, kv, start=cur,
                                             window=self.window,
                                             impl=self.attn_impl)
            else:
                o = attn.chunk_attend(q, kv, qpos=pos, window=self.window)
        elif table is not None:
            attn.paged_write_rows(kv.k, kv.v, k, v, rows)
            if kernel:
                o = attn.paged_decode_attend_kernel(q, kv, table, pos=cur,
                                                    window=self.window,
                                                    impl=self.attn_impl)
            else:
                o = attn.paged_decode_attend(q, kv, table, pos=pos,
                                             window=self.window)
        else:
            attn.cache_write(kv, k, v, pos)
            if kernel:
                o = attn.decode_attend_kernel(q, kv, pos=cur,
                                              window=self.window,
                                              impl=self.attn_impl)
            else:
                o = attn.decode_attend(q, kv, pos=pos, window=self.window)
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

    def _channel(self, layer: Layer, h, aux: list | None):
        """The channel mix (ref ``_channel_mix``, ``transformer.py:
        255-270``): the MoE FFN, whose load-balance loss is appended to
        ``aux`` when a list is given, or the dense MLP, or nothing."""
        if layer.moe is not None:
            cfg = self.cfg
            y, a = moe.moe_forward(layer.moe, layer.norm2(h), top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   need_aux=aux is not None)
            if aux is not None:
                aux.append(a)
            return h + y
        if layer.mlp is not None:
            return h + layer.mlp(layer.norm2(h))
        return h

    def _ssd(self, layer: Layer, x, *, mode, state):
        """Temporal mixing of an SSD layer: the chunked scan (through
        the kernel dispatch on ``attn_impl``'s rule) for prefill and
        forward, the single-step update for decode; ``state`` (None in
        ``full`` mode) is updated in place."""
        impl = self.attn_impl if self._use_kernel(x) else None
        return ssd.ssd_block(layer.mix, x, state, chunk=self.cfg.ssm_chunk,
                             single_step=mode == "decode", impl=impl)

    def _stack(self, h, *, mode, cache=None, rope, pos=None, cur=None,
               aux: list | None = None):
        table = cache.block_table if cache is not None else None
        rows = None
        if table is not None and mode == "decode":
            # one step's rows, located once: the block size is the pool's
            # own (a model built without paging serves any pool), and pos
            # is written for every layer in one go
            rows = attn.paged_locate(table, pos, cache.k.shape[2],
                                     cache.pos.shape[2])
            attn.paged_write_pos(cache.pos, rows)
        for i, layer in enumerate(self.layers):
            lc = cache.layer(i) if cache is not None else None
            if self.recurrent:
                h = h + self._ssd(layer, layer.norm1(h), mode=mode, state=lc)
            elif self.latent:
                h = h + self._mla(layer, layer.norm1(h), mode=mode, lc=lc,
                                  rope=rope, pos=pos)
            else:
                h = h + self._attn(layer, layer.norm1(h), mode=mode, kv=lc,
                                   rope=rope, pos=pos, cur=cur, table=table,
                                   rows=rows)
            h = self._channel(layer, h, aux)
        return h

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- modes ----------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens):
        """Full-sequence logits [B, S, V]; returns (logits, aux_loss): the
        MoE layers' load-balance losses summed, f32 (0 without MoE)."""
        tokens = self._tokens(tokens)
        h = self.embed(tokens)
        rope = self._rope(torch.arange(tokens.shape[1], device=self.device))
        aux = []
        h = self._stack(h, mode="full", rope=rope, aux=aux)
        return self.unembed(h), (torch.stack(aux).sum() if aux else
                                 torch.zeros((), device=self.device))

    @torch.no_grad()
    def prefill(self, tokens, cache: Cache):
        """Consume the prompt, fill the cache from position 0, and return
        (last-position logits [B, 1, V], cache).  A paged pool is
        refused: prefill a contiguous row cache and scatter it."""
        if cache.block_table is not None:
            raise ValueError(
                "prefill into a paged pool is not supported — prefill a "
                "contiguous row cache and scatter it into the pool blocks "
                "(see repro_torch.serving.continuous.paged_slot_write)")
        tokens = self._tokens(tokens)
        h = self.embed(tokens)
        S = tokens.shape[1]
        rope = self._rope(torch.arange(S, device=self.device))
        h = self._stack(h, mode="prefill", cache=cache, rope=rope)
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
                        rope=self._rope(positions), pos=pos, cur=cur)
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
        Contiguous homogeneous attention stacks only (an MoE channel mix
        routes the chunk's B*n tokens as one group).  At n = 1 it is a
        decode step whose write does not wrap: the speculative window's
        draft steps."""
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
