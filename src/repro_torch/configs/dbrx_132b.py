"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base].

40 layers, d_model 6144, 48 Q heads / 8 KV heads (GQA), 16 experts
top-4, per-expert d_ff 10 752, vocab 100 352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab=100_352,
    n_experts=16,
    top_k=4,
    d_ff_expert=10_752,
    act="silu",
    norm="layernorm",
    tie_embeddings=False,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=128, n_experts=4, top_k=2,
                          d_ff_expert=128, vocab=512, remat=False)
