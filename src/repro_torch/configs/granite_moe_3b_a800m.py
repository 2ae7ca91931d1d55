"""granite-moe-3b-a800m — fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family, scaled per assignment].

32 layers, d_model 1536, 24 Q heads / 8 KV heads (GQA), per-expert
d_ff 512, 40 experts with top-8 routing, vocab 49 155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                 # per-expert width (fine-grained experts)
    vocab=49_155,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab=512, n_experts=4, top_k=2,
        d_ff_expert=64, act="silu", remat=False,
        source=CONFIG.source)
