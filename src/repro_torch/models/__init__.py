"""Model zoo, PyTorch port: the dense GQA decoder family."""

from . import attention, cache_update, layers, model, transformer
from .model import (
    cache_batch_axes,
    decode_step,
    forward,
    head_weight,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "attention",
    "cache_update",
    "layers",
    "model",
    "transformer",
    "cache_batch_axes",
    "decode_step",
    "forward",
    "head_weight",
    "init_cache",
    "init_params",
    "prefill",
]
