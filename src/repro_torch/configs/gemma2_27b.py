"""gemma2-27b [dense]: local(4096-window)/global alternating attention,
logit softcaps, sandwich norms, tied embeddings.  46L d_model=4608 32H
(kv=16) d_ff=36864 vocab=256000.  [arXiv:2408.00118; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10_000.0,
    sliding_window=4096,
    global_every=2,          # layers alternate local, global
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    act="gelu",
    tie_embeddings=True,
    norm_scale_offset=True,
    attn_scale=144.0 ** -0.5,  # query_pre_attn_scalar = d_model / n_heads
    embed_scale=True,
)
