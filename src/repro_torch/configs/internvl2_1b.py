"""internvl2-1b [vlm]: InternViT frontend (stub) + InternLM2/Qwen2-class
backbone.  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
[arXiv:2404.16821; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    rope_theta=1_000_000.0,
    attn_bias=True,          # Qwen2-style QKV bias in the backbone
    tie_embeddings=True,     # 0.5B-class backbones tie embeddings
    frontend="vision_stub",
    num_prefix_tokens=256,   # precomputed ViT patch embeddings per image
)
