"""stablelm-3b — dense MHA decoder [hf:stabilityai/stablelm-2-1_6b family].

32 layers, d_model 2560, 32 heads (MHA, kv=32), d_ff 6912,
vocab 50 304, partial rotary (25 %), LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50_304,
    rope_pct=0.25,
    qkv_bias=False,
    act="silu",
    norm="layernorm",
    tie_embeddings=False,
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab=512, remat=False)
