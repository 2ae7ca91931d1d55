"""mamba2-780m — attention-free SSM with SSD [arXiv:2405.21060].

48 layers, d_model 1536, ssm_state 128, expand 2 (d_inner 3072,
48 heads of headdim 64), vocab 50 280.  O(1) decode state: the natural
winner of the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # no separate MLP — SSD block only
    vocab=50_280,
    head_dim=1,
    attention="none",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2/SSD)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, vocab=512, ssm_state=16,
                          ssm_headdim=32, ssm_chunk=8, remat=False)
