"""recurrentgemma-2b — hybrid RG-LRU + local attention [arXiv:2402.19427].

26 layers in a (recurrent, recurrent, local-attention) 2:1 pattern,
d_model 2560, 10 Q heads with a single KV head (MQA), GeGLU d_ff 7680,
vocab 256 000, local-attention window 2048, head_dim 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    window=2048,
    layer_pattern=("rglru", "rglru", "local_attn"),
    lru_width=2560,
    conv_width=4,
    act="gelu",
    norm="rmsnorm",
    scale_embeddings=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab=512, window=16,
                          lru_width=128, remat=False)
