"""moonlight-16b-a3b — DeepSeek-V3 blocks without multi-token prediction
[hf:moonshotai/Moonlight-16B-A3B].

27 layers, d_model 2048, vocab 163 840, untied.  Multi-head Latent
Attention with 16 heads: no q low rank, kv_lora_rank 512, qk_nope 128,
qk_rope 64, v 128 (the decode cache stores 512 + 64 values a token and
layer).  Layer 0 is dense (SwiGLU of 11 264); layers 1-26 are MoE: 64
routed experts of 1 408, top 6, and 2 shared experts, routed on sigmoid
scores plus a correction bias, the chosen scores renormalised and
scaled by 2.446.  15.96 B parameters, 2.9 B active a token.

``capacity_factor`` 11.0 (>= 64 / 6) makes the port's GShard capacity
equal the group at every group size, so no token is dropped, as the
published model routes.  The port's RMSNorm eps is 1e-6 (published
1e-5) and its norms are ``x * (1 + scale)``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11_264,              # the dense layer 0
    vocab=163_840,
    head_dim=192,             # qk_nope + qk_rope
    attention="mla",
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    capacity_factor=11.0,
    first_dense_layers=1,
    n_shared_experts=2,
    router_score="sigmoid",
    routed_scale=2.446,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=24, d_ff=96, vocab=512, kv_lora_rank=32,
                          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                          n_experts=8, top_k=3, d_ff_expert=16, remat=False)
