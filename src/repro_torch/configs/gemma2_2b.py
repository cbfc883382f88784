"""Gemma2-2B [arXiv:2408.00118]: local(4096)+global alternating attention,
logit softcap 30 / attn softcap 50. 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 head_dim=256. `swa_variant()` windows every layer — used for the
long_500k decode shape (sliding-window KV cache = O(window))."""
import dataclasses

from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    stages=(((ATTN_LOCAL, ATTN), 13),),
    window_size=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)


def swa_variant() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma2-2b-swa", stages=(((ATTN_LOCAL,), 26),))
