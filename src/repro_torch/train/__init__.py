"""Training substrate, PyTorch port of `repro.train`: optimizer, fused
cross-entropy, the stateless train step, storage-backed checkpoints and the
elastic driver."""

from . import checkpoint, elastic, fused_ce, optimizer, train_step
from .elastic import ElasticTrainConfig, train_elastic
from .optimizer import adamw, apply_updates, clip_by_global_norm, constant_schedule, cosine_schedule
from .train_step import TrainState, init_train_state, make_loss_fn, make_train_step

__all__ = [
    "checkpoint", "elastic", "fused_ce", "optimizer", "train_step",
    "adamw", "apply_updates", "clip_by_global_norm", "constant_schedule", "cosine_schedule",
    "TrainState", "init_train_state", "make_loss_fn", "make_train_step",
    "ElasticTrainConfig", "train_elastic",
]
