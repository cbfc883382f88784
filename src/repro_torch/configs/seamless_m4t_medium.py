"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder speech/text model.
12L (decoder; +12 encoder) d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206. Audio frontend (mel + conformer feature extractor) is a stub:
input_specs() supplies frame embeddings (B, frames, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    frontend="audio",
    encoder_frames_ratio=4,
    tie_embeddings=True,
    source="arXiv:2308.11596",
)
