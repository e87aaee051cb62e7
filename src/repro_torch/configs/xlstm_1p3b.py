"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks at 7:1.  48L d_model=2048 4H
d_ff=0 (projections live inside the blocks) vocab=50304.
[arXiv:2405.04517; unverified]"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, slstm_proj_factor=4.0 / 3.0),
)
