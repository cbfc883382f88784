"""Qwen2-VL-7B [arXiv:2409.12191]: M-RoPE, dynamic-resolution VLM.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 head_dim=128.
Vision frontend is a stub per the brief: input_specs() supplies patch
embeddings (B, num_patches, d_model) + 3D M-RoPE position ids."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
    num_patches=1024,
    tie_embeddings=False,
    source="arXiv:2409.12191",
)
