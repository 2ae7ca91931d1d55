"""paligemma-3b — VLM: SigLIP vision encoder + gemma decoder
[arXiv:2407.07726].

Language backbone: 18 layers, d_model 2048, 8 Q heads / 1 KV head (MQA),
head_dim 256, d_ff 16384, vocab 257 216.  The SigLIP encoder + projector
is STUBBED — ``input_specs`` provides 256 patch embeddings [B, 256, 2048]
that join the token stream as a bidirectional prefix (prefix-LM mask).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16_384,
    vocab=257_216,
    head_dim=256,
    n_patches=256,
    prefix_lm=True,
    act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2407.07726 (PaliGemma)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab=512, n_patches=8,
                          remat=False)
