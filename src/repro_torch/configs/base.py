"""Model/arch configuration system, a copy of ``repro.configs.base``.

Every assigned architecture gets a ``configs/<id>.py`` exposing
``CONFIG`` (the exact published shape) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  ``configs.registry``
resolves ``--arch <id>`` strings.  The port keeps its own copy so that
it imports nothing of ``repro``; only ``attn_impl``'s values differ.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    source: str = ""                # citation for the shape

    # attention flavour
    attention: str = "gqa"          # gqa | mla | none
    window: int = 0                 # >0: sliding-window (sub-quadratic) attn
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0           # partial rotary (stablelm: 0.25)
    qkv_bias: bool = False
    prefix_lm: bool = False         # bidirectional prefix (paligemma)
    attn_impl: str = "auto"         # auto | xla | ref | cuda — route
                                    # attn/local_attn layers through the
                                    # repro_torch.kernels dispatch
                                    # ("auto": the hand-written CUDA
                                    # kernels on a CUDA tensor, raising
                                    # on a card that is not sm_90; on a
                                    # CPU tensor the model's own einsum
                                    # path, bitwise-identical to "xla";
                                    # "ref": the kernels' plain versions;
                                    # "cuda": the kernels or raise;
                                    # "xla" bypasses the dispatch)

    # paged KV pool (vLLM-style) for continuous decode.  0 = the
    # contiguous per-slot layout (the parity oracle).  >0 = one shared
    # block pool of kv_pool_blocks x kv_block_size rows per layer with
    # a per-slot block table; slots map only the blocks their request
    # budget needs, so short requests stop reserving worst-case HBM.
    kv_block_size: int = 0          # rows per KV block (0 = contiguous)
    kv_pool_blocks: int = 0         # physical blocks in the pool
                                    # (0 = capacity parity with the
                                    # contiguous pool at init_cache
                                    # time; block 0 is the reserved
                                    # trash block)

    # decode-time sampling defaults (engine-level; per-request
    # SamplingParams override them).  temperature 0 = greedy — bitwise
    # identical to the pre-sampling argmax path.  ``sample_top_k`` is
    # named apart from the MoE router's ``top_k`` field below.
    temperature: float = 0.0
    sample_top_k: int = 0           # 0 = no top-k filter
    sample_top_p: float = 1.0       # 1.0 = no nucleus filter
    sampling_seed: int = 0          # base PRNG stream (fold rid, pos)

    # self-speculative decoding: the draft model is the FIRST
    # ``draft_layers`` layers of this same stack (shallow exit through
    # the shared final norm + unembed).  0 disables drafting; the
    # serving engine's ``draft_depth`` picks how many tokens the draft
    # proposes per verify step.
    draft_layers: int = 0

    # per-layer pattern for hybrids: tuple of block kinds, tiled over
    # n_layers.  Empty -> homogeneous (kind inferred from family).
    layer_pattern: Tuple[str, ...] = ()

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0     # leading layers with the dense SwiGLU
                                    # of width d_ff instead of the MoE
    n_shared_experts: int = 0       # a shared SwiGLU of width
                                    # n_shared_experts * d_ff_expert that
                                    # every token takes (DeepSeek's)
    router_score: str = "softmax"   # softmax | sigmoid (DeepSeek-V3's, with
                                    # a float32 [E] correction bias added
                                    # to the scores for the choice only)
    routed_scale: float = 1.0       # the renormalised gates' scale

    # MLA (minicpm3 / deepseek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                # frames after the (stubbed) conv frontend
    enc_d_model: int = 0            # 0 -> d_model

    # VLM (paligemma) — stubbed SigLIP frontend
    n_patches: int = 0

    # misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # mlp activation family
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma-style sqrt(d) input scaling
    parallel_block: bool = False    # attn and MLP share the residual input
    dtype: str = "bfloat16"
    remat: bool = True              # checkpoint each layer in train_step
    remat_policy: str = "full"      # full | dots (save matmul outputs,
                                    # recompute elementwise only) | none
    scan_unroll: bool = False       # unroll the layer scan (dry-run FLOP
                                    # extrapolation needs while-free HLO)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "hybrid" and not self.layer_pattern:
            raise ValueError("hybrid arch needs layer_pattern")
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"router_score must be 'softmax' or 'sigmoid', "
                             f"got {self.router_score!r}")
        if self.kv_pool_blocks > 0 and self.kv_block_size <= 0:
            raise ValueError(
                "kv_pool_blocks is set but kv_block_size is 0 — the "
                "paged KV pool only engages when kv_block_size > 0, "
                "so this config would silently serve the contiguous "
                "layout; set kv_block_size too")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if self.sample_top_k < 0:
            raise ValueError(
                f"sample_top_k must be >= 0 (0 = off), got "
                f"{self.sample_top_k}")
        if not 0 < self.sample_top_p <= 1.0:
            raise ValueError(
                f"sample_top_p must be in (0, 1], got "
                f"{self.sample_top_p}")
        if self.draft_layers < 0 or (self.n_layers and
                                     self.draft_layers >= self.n_layers):
            raise ValueError(
                f"draft_layers must be in [0, n_layers) — the draft is "
                f"a strict shallow prefix of the stack; got "
                f"draft_layers={self.draft_layers} with "
                f"n_layers={self.n_layers}")

    # ---- derived ---------------------------------------------------------
    @property
    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind, length n_layers."""
        if self.layer_pattern:
            pat = self.layer_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        kind = {"ssm": "ssd"}.get(self.family, None)
        if kind is None:
            kind = "mla" if self.attention == "mla" else (
                "local_attn" if self.window else "attn")
        return (kind,) * self.n_layers

    @property
    def homogeneous(self) -> bool:
        kinds = self.block_kinds
        return all(k == kinds[0] for k in kinds)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def paged_kv(self) -> bool:
        """Decode KV caches live in a shared paged block pool."""
        return self.kv_block_size > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does NOT grow linearly with full seq len
        for every layer (SSM / hybrid with windowed attention / SWA)."""
        kinds = set(self.block_kinds)
        quad = {"attn", "mla"}
        return not (kinds & quad)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * d + (0 if self.tie_embeddings else V * d)
        for i, kind in enumerate(self.block_kinds):
            if kind in ("attn", "local_attn"):
                total += d * (H + 2 * K) * hd + H * hd * d
            elif kind == "mla":
                q_in = self.q_lora_rank or d
                qk = self.qk_nope_dim + self.qk_rope_dim
                total += (d * self.q_lora_rank if self.q_lora_rank else 0)
                total += q_in * H * qk
                total += d * (self.kv_lora_rank + self.qk_rope_dim)
                total += self.kv_lora_rank * H * (self.qk_nope_dim
                                                  + self.v_head_dim)
                total += H * self.v_head_dim * d
            elif kind == "ssd":
                din = self.ssm_expand * d
                nh = din // self.ssm_headdim
                total += d * (2 * din + 2 * self.ssm_state + nh) + din * d
            elif kind == "rglru":
                r = self.lru_width or d
                total += d * 2 * r + r * d + 3 * r * r  # approx gates
            if self.moe_layer(i):
                total += self.n_experts * (3 * d * self.d_ff_expert)
                total += d * self.n_experts
                total += 3 * d * self.n_shared_experts * self.d_ff_expert
                total += self.n_experts if self.router_score == "sigmoid" else 0
            elif f:
                total += 3 * d * f
            total += 2 * d  # norms
        if self.family == "encdec":
            ed = self.enc_d_model or d
            total += self.n_enc_layers * (4 * ed * ed + 3 * ed * self.d_ff)
            total += self.n_layers * (4 * d * d)  # cross-attn
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params()
        dense_like = self.n_params()
        n_moe = sum(map(self.moe_layer, range(self.n_layers)))
        unused = (self.n_experts - self.top_k) * n_moe * (
            3 * self.d_model * self.d_ff_expert)
        return dense_like - unused

    def moe_layer(self, i: int) -> bool:
        """Whether layer i's channel mix is the MoE (an MoE config's
        layers from ``first_dense_layers`` on)."""
        return self.is_moe and i >= self.first_dense_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
