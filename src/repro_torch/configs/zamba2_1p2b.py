"""zamba2-1.2b [hybrid]: Mamba2 backbone + one *shared* attention block
(weights reused) invoked every 6 layers on concat(hidden, embeddings).
38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4, num_groups=2),
    shared_attn_every=6,
)
