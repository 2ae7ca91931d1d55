"""llama3-405b — dense GQA decoder at scale [arXiv:2407.21783].

126 layers, d_model 16384, 128 Q heads / 8 KV heads, d_ff 53 248,
vocab 128 256.  The mesh-scale stressor for the dry-run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    vocab=128_256,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512, remat=False)
