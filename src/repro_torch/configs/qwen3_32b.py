"""qwen3-32b [dense]: GQA kv=8 with per-head q/k RMSNorm.  64L d_model=5120
64H d_ff=25600 vocab=151936.  [hf:Qwen/Qwen3-8B; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
)
