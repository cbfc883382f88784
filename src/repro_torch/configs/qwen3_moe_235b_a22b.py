"""Qwen3-MoE 235B-A22B family config [hf:Qwen/Qwen3-30B-A3B scaled per brief].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8, QK-norm (Qwen3 signature), head_dim=128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    router_aux_weight=0.001,
    source="hf:Qwen/Qwen3-30B-A3B (arch family), brief-assigned dims",
)
