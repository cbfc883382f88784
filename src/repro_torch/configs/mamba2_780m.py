"""Mamba2-780m [arXiv:2405.21060]: SSD (state-space duality), attention-free.
48L d_model=1536 ssm_state=128, expand=2 (d_inner=3072), head_dim=64
(48 SSM heads), vocab=50280."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
