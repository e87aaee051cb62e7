"""Elastic, fault-tolerant training on the stateless-function runtime (port
of `repro.train.elastic`).

The unit of work is a **step chunk**: run K training steps from checkpoint
version v, publish version v+1.  Properties inherited from the PyWren
contract:

  * *stateless*: a chunk task reads its version as input; parameters and
    optimizer state come from storage; nothing depends on which worker runs
    it;
  * *idempotent*: batches are a pure function of the step index and the
    chunk runs under ``torch.use_deterministic_algorithms(True)``, so a
    duplicate writes byte-identical checkpoint leaves; the manifest's
    atomic publish makes re-execution and speculation safe;
  * *warm containers*: a worker that just produced v keeps the state in
    memory; if it picks up the chunk for v+1 it skips the storage load.

The driver runs chunks through the port's `WrenExecutor`, so scheduling,
retries, lease recovery and speculation come from `repro_torch.core`.
The runtime ships callables with the standard ``pickle``: the chunk is a
module-level class holding the config, the optimizer, the store's handle
(pickled by reference), the training config, the batch source (a
module-level function or a ``functools.partial`` of one) and the device,
and no tensor.

The store may be a ``FileBackend`` root that other processes share: a
fresh process calling ``train_elastic`` for the same run resumes at
``latest_version`` and continues the same losses bit for bit.  It may also
hold a run the JAX package began: the chunk passes its config and
optimizer to `checkpoint.load`, which reads a JAX-written version into the
port's layout.

Deterministic mode on CUDA needs ``CUBLAS_WORKSPACE_CONFIG`` set before the
process's first cuBLAS call; importing `repro_torch` sets it (see
`repro_torch.__init__`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import WrenExecutor, get_all
from repro_torch.storage import ObjectStore

from . import checkpoint as ckpt
from .optimizer import AdamW, AdamWState
from .train_step import TrainState, init_train_state, make_train_step


@dataclass
class ElasticTrainConfig:
    run: str = "run0"
    steps_per_chunk: int = 10
    total_steps: int = 100
    keep_checkpoints: int = 3
    grad_clip: float = 1.0
    microbatches: int = 1
    remat: bool = False


# per-process warm cache: (run, version) -> TrainState (the container-reuse
# trick).  Read through a runtime import inside the task body, as the JAX
# package does (there, cloudpickle would capture the dict by value; the
# standard pickle stores the chunk's class by reference, and the import
# keeps the task body's reach to the live dict explicit).
WARM_CACHE: Dict[Tuple[str, int], TrainState] = {}


def _live_warm_cache() -> Dict[Tuple[str, int], TrainState]:
    import repro_torch.train.elastic as _el

    return _el.WARM_CACHE


def _as_state(tree) -> TrainState:
    params, (step, m, v) = tree
    return TrainState(params=params, opt_state=AdamWState(step=step, m=m, v=v))


class ChunkFn:
    """The stateless chunk task: ``chunk(version)`` runs
    ``tcfg.steps_per_chunk`` steps from checkpoint ``version`` on
    ``device``, saves ``version + 1`` and returns the last step's metrics
    as floats plus ``warm_start``."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, store: ObjectStore,
                 tcfg: ElasticTrainConfig, batch_fn: Callable[[int], Dict[str, torch.Tensor]],
                 device) -> None:
        self.cfg, self.opt, self.store, self.tcfg = cfg, opt, store, tcfg
        self.batch_fn, self.device = batch_fn, torch.device(device)

    def __call__(self, version: int) -> Dict[str, float]:
        tcfg = self.tcfg
        step_fn = make_train_step(
            self.cfg, self.opt,
            remat=tcfg.remat, grad_clip=tcfg.grad_clip, microbatches=tcfg.microbatches,
        )
        cache = _live_warm_cache()
        key = (tcfg.run, version)
        if key in cache:  # warm container: skip the storage load
            state = cache.pop(key)
            warm = True
        else:
            tree, _, _ = ckpt.load(self.store, tcfg.run, version, device=self.device,
                                   cfg=self.cfg, opt=self.opt)
            state = _as_state(tree)
            warm = False
        base_step = version * tcfg.steps_per_chunk
        metrics: Dict[str, float] = {}
        was_deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            for i in range(tcfg.steps_per_chunk):
                batch = {k: v.to(self.device) for k, v in self.batch_fn(base_step + i).items()}
                state, m = step_fn(state, batch)
                metrics = {k: float(v) for k, v in m.items()}
        finally:
            torch.use_deterministic_algorithms(was_deterministic)
        ckpt.save(
            self.store, tcfg.run, version + 1, tuple(state),
            meta={"step": base_step + tcfg.steps_per_chunk, "metrics": metrics},
        )
        cache[(tcfg.run, version + 1)] = state
        metrics["warm_start"] = 1.0 if warm else 0.0
        return metrics


def make_chunk_fn(
    cfg: ModelConfig,
    opt: AdamW,
    store: ObjectStore,
    tcfg: ElasticTrainConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    device=None,
) -> ChunkFn:
    """The stateless chunk task shipped through the runtime, on ``device``
    (``cuda`` by default)."""
    return ChunkFn(cfg, opt, store, tcfg, batch_fn, resolve_device(device))


def train_elastic(
    wex: WrenExecutor,
    cfg: ModelConfig,
    opt: AdamW,
    tcfg: ElasticTrainConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    *,
    seed: int = 0,
    scale_plan: Optional[Dict[int, int]] = None,  # chunk idx -> worker count
    timeout_s: float = 600.0,
    device=None,
) -> List[Dict[str, float]]:
    """Run total_steps in chunks through the serverless runtime, on
    ``device`` (``cuda`` by default); version 0 is `init_train_state` from
    a generator seeded with ``seed``."""
    dev = resolve_device(device)
    store = wex.store
    if ckpt.latest_version(store, tcfg.run) is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_train_state(cfg, opt, gen, dev)
        ckpt.save(store, tcfg.run, 0, tuple(state), meta={"step": 0})
        del state

    chunk_fn = make_chunk_fn(cfg, opt, store, tcfg, batch_fn, dev)
    n_chunks = tcfg.total_steps // tcfg.steps_per_chunk
    history: List[Dict[str, float]] = []
    start_v = ckpt.latest_version(store, tcfg.run) or 0
    for chunk_idx in range(start_v, n_chunks):
        if scale_plan and chunk_idx in scale_plan:
            wex.scale_to(scale_plan[chunk_idx])  # elastic resize mid-run
        [metrics] = get_all(wex.map(chunk_fn, [chunk_idx]), timeout_s=timeout_s)
        history.append(metrics)
        ckpt.gc_old_versions(store, tcfg.run, keep=tcfg.keep_checkpoints)
    return history
