"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: MLA (multi-head latent attention).
62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448; MLA ranks per model card:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
)
