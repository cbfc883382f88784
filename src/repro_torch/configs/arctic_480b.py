"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]:
dense-MoE hybrid — a dense residual FFN in parallel with a 128-expert top-2
MoE. 35L d_model=7168 56H (GQA kv=8) per-expert d_ff=4864 vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_d_ff=4864,
    dense_residual=True,
    tie_embeddings=False,
    router_aux_weight=0.001,
    source="hf:Snowflake/snowflake-arctic-base",
)
