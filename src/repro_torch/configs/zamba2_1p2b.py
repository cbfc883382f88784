"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared-parameter
attention blocks (one attention+MLP unit reused every 6th block).
38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64 vocab=32000.
Shared attention is windowed (window=4096) so the hybrid stays sub-quadratic
for long_500k (see DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import MAMBA, SHARED_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    stages=(
        ((MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, SHARED_ATTN), 6),
        ((MAMBA,), 2),
    ),
    window_size=4096,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
