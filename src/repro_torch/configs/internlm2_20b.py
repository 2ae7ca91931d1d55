"""internlm2-20b — dense GQA decoder [arXiv:2403.17297].

48 layers, d_model 6144, 48 Q heads / 8 KV heads, d_ff 16384,
vocab 92 544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=92_544,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297 (InternLM2)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512, remat=False)
