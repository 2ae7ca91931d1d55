"""whisper-medium — encoder-decoder audio transformer [arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 51 865.  The mel-spectrogram + conv frontend is STUBBED:
``input_specs`` provides precomputed frame embeddings [B, 1500, 1024].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51_865,
    n_enc_layers=24,
    enc_seq=1500,              # 30 s of audio after the conv frontend
    qkv_bias=True,
    act="gelu_mlp",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=10_000.0,       # decoder self-attn uses rope in our port
    source="arXiv:2212.04356 (Whisper)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                          vocab=512, enc_seq=32, remat=False)
