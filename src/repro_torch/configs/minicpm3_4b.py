"""minicpm3-4b — dense decoder with Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B].

62 layers, d_model 2560, 40 heads, d_ff 6400, vocab 73 448.
MLA: q_lora_rank 768, kv_lora_rank 256, qk_nope 64, qk_rope 32, v 64 —
the decode cache stores only (256 + 32) floats/token.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73_448,
    head_dim=96,              # qk_nope + qk_rope
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10_000.0,
    source="hf:openbmb/MiniCPM3-4B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=24, d_ff=256, vocab=512, q_lora_rank=48,
                          kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                          v_head_dim=16, remat=False)
