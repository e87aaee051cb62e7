"""Model zoo, PyTorch port: the dense GQA decoder family, the MoE family
(olmoe; deepseek-v3 with MLA and its MTP head), the zamba2 hybrid (Mamba2
layers with a shared attention block) and xLSTM (mLSTM and sLSTM
blocks)."""

from . import (
    attention, cache_update, layers, mamba2, mla, model, moe, sharding, transformer, xlstm,
)
from .model import (
    cache_batch_axes,
    decode_step,
    forward,
    forward_hidden,
    head_weight,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "attention",
    "cache_update",
    "layers",
    "mamba2",
    "mla",
    "model",
    "moe",
    "sharding",
    "transformer",
    "xlstm",
    "cache_batch_axes",
    "decode_step",
    "forward",
    "forward_hidden",
    "head_weight",
    "init_cache",
    "init_params",
    "prefill",
]
