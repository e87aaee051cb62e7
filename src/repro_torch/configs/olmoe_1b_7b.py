"""olmoe-1b-7b [moe]: 64 experts top-8, QK-norm.  16L d_model=2048 16H
(kv=16) d_ff_expert=1024 vocab=50304.  [arXiv:2409.02060; hf]"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    rope_theta=10_000.0,
    qk_norm=True,
    moe=MoEConfig(
        num_experts=64,
        num_shared=0,
        top_k=8,
        d_ff_expert=1024,
        num_dense_layers=0,
        capacity_factor=1.25,
    ),
)
