"""Parameter server on the KV store (paper §3.3 'Parameter Servers').

'We can implement HOGWILD! stochastic gradient descent by having each
function compute the gradients based on the latest version of shared model.
Since the only coordination across functions happens through the parameter
server, such applications fit very well into the stateless function model.'

Design:
  * the model is split into **blocks** (the paper's 'range updates'), each a
    KV key, sharded across KV shards;
  * workers ``pull()`` the latest blocks, compute a gradient on their datum,
    and ``push()`` deltas via server-side ``eval`` — atomic per block, no
    global lock: HOGWILD! semantics;
  * optional **staleness bound** (the paper's 'flexible consistency
    models'): a version counter per block; pushes older than ``max_staleness``
    versions are rejected and the worker re-pulls;
  * optional int8 **gradient compression** with stochastic rounding — a
    beyond-paper distributed-optimization trick (bytes through the KV store
    are the PS bottleneck, as Fig 4 quantifies);
  * **batched pulls** — ``pull()`` fetches every block and version counter
    in one ``KVStore.mget`` (one amortized round-trip per KV shard touched,
    not one per block), and ``wait_fresh()`` lets a staleness-rejected
    worker block on the version key's *shard condition* until another
    worker's push advances it — no re-pull spinning;
  * **batched pushes** — ``push_delta()`` is the write-side mirror: the
    staleness check reads all version counters in one ``mget``, then all
    block updates ride one ``KVStore.eval_many`` and all version bumps a
    second (at most two round-trips per KV shard touched, instead of
    2·num_blocks synchronous writes; data lands strictly before versions
    so a ``wait_fresh`` reader can never observe a version ahead of its
    block).  Per-block atomicity is preserved — each update still applies
    under its shard lock — so HOGWILD! semantics are unchanged; only the
    wire cost collapses.

Port of `repro.core.ps`.  The runtime ships callables with the standard
``pickle``, so ``hogwild_sgd``'s task is a ``functools.partial`` of the
module-level :func:`_hogwild_worker`, and the user's ``grad_fn`` must
pickle by reference (a module-level function, or a partial of one).  So
do the update functions ``push_delta`` hands ``eval_many``, which a
``repro-kvd`` daemon runs server-side: where the JAX package has the
lambdas ``cur + c`` and ``int(v or 0) + 1``, the port sends
``partial(operator.add, c)`` and ``partial(operator.add, 1)`` with
``default=0`` (the same values: IEEE addition commutes), standard-library
functions that a JAX daemon resolves as well as the port's.  The int8 path
draws from numpy's generator, as JAX's does, so it rounds the same way for
the same ``rng``.
"""

from __future__ import annotations

import operator
import time
import uuid
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage import KVStore

from .futures import get_all
from .wren import WrenExecutor


_BUMP = partial(operator.add, 1)  # a version counter's increment


def _quantize_int8(arr: np.ndarray, rng: np.random.Generator) -> Tuple[np.ndarray, float]:
    scale = float(np.max(np.abs(arr))) / 127.0 if arr.size else 1.0
    if scale == 0.0:
        scale = 1.0
    scaled = arr / scale
    low = np.floor(scaled)
    frac = scaled - low
    q = low + (rng.random(arr.shape) < frac)  # stochastic rounding
    return np.clip(q, -127, 127).astype(np.int8), scale


def _dequantize_int8(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * scale


@dataclass
class PSConfig:
    num_blocks: int = 8
    max_staleness: Optional[int] = None  # None = fully async (HOGWILD!)
    compress_int8: bool = False


class ParameterServer:
    """Blocked parameter server over a KVStore."""

    def __init__(self, kv: KVStore, params: np.ndarray, config: PSConfig, name: str = "ps") -> None:
        self.kv = kv
        self.config = config
        self.name = f"{name}-{uuid.uuid4().hex[:6]}"
        self.dim = int(params.size)
        self.block_slices = self._make_blocks(self.dim, config.num_blocks)
        # One batched write seeds all blocks + version counters (one
        # round-trip per shard, not 2·num_blocks sets).
        init: "dict" = {}
        for b, sl in enumerate(self.block_slices):
            init[self._bkey(b)] = params[sl].copy()
            init[self._vkey(b)] = 0
        self.kv.mset(init, worker="ps-init")

    @staticmethod
    def _make_blocks(dim: int, n: int) -> List[slice]:
        edges = np.linspace(0, dim, n + 1).astype(int)
        return [slice(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]

    def _bkey(self, b: int) -> str:
        return f"{self.name}/block/{b}"

    def _vkey(self, b: int) -> str:
        return f"{self.name}/ver/{b}"

    # ---- client ops ------------------------------------------------------
    def pull(self, worker: str = "-") -> Tuple[np.ndarray, List[int]]:
        """Fetch all blocks + version counters in one batched ``mget`` —
        one amortized round-trip per KV shard instead of 2·num_blocks
        synchronous gets (the Fig 4 latency, paid once per shard)."""
        n = len(self.block_slices)
        keys = [self._bkey(b) for b in range(n)] + [self._vkey(b) for b in range(n)]
        vals = self.kv.mget(keys, worker=worker)
        parts = vals[:n]
        vers = [int(v) if v is not None else 0 for v in vals[n:]]
        return np.concatenate(parts), vers

    def wait_fresh(
        self, block: int, seen_version: int, timeout_s: float = 5.0, worker: str = "-"
    ) -> int:
        """Block until ``block``'s version advances past ``seen_version``
        (another worker pushed), waiting on the version key's shard
        condition — woken by the push itself, no polling.  Returns the
        current version (which may still equal ``seen_version`` on
        timeout)."""
        vkey = self._vkey(block)
        deadline = time.monotonic() + timeout_s
        while True:
            seq = self.kv.shard_seq(vkey)
            # reprolint: disable=BATCH001(single-key recheck between shard-condition waits; there is no fan-out to batch)
            ver = int(self.kv.get(vkey, 0, worker=worker))
            if ver > seen_version:
                return ver
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return ver
            self.kv.wait_key(vkey, seq, remaining)

    def push_delta(
        self,
        delta: np.ndarray,
        pulled_versions: Optional[List[int]] = None,
        worker: str = "-",
        rng: Optional[np.random.Generator] = None,
    ) -> int:
        """Apply delta block-wise.  Returns number of blocks applied (blocks
        rejected for staleness are skipped — caller may re-pull).

        Batched: one ``mget`` covers the staleness check for every block,
        then all accepted block updates land in one ``eval_many`` and all
        version bumps in a second — at most two round-trips per KV shard
        instead of 2·num_blocks synchronous writes.  The two-phase order
        matters: version keys may live on different shards than their
        blocks, and publishing them together in one per-shard pass could
        bump a version *before* its block data lands — a ``wait_fresh``
        reader would then pull stale data believing it fresh.  Data first,
        versions second preserves the old eval-then-incr guarantee.  Each
        block's range update still applies atomically under its shard lock
        (HOGWILD!); batching changes the wire cost only."""
        rng = rng or np.random.default_rng(0)
        n = len(self.block_slices)
        stale: set = set()
        if self.config.max_staleness is not None and pulled_versions is not None:
            vers = self.kv.mget(
                [self._vkey(b) for b in range(n)], default=0, worker=worker
            )
            for b, cur_ver in enumerate(vers):
                if int(cur_ver or 0) - pulled_versions[b] > self.config.max_staleness:
                    stale.add(b)
        block_updates: "dict" = {}
        version_bumps: "dict" = {}
        applied = 0
        for b, sl in enumerate(self.block_slices):
            if b in stale:
                continue
            chunk = delta[sl]
            if self.config.compress_int8:
                q, scale = _quantize_int8(chunk, rng)
                chunk = _dequantize_int8(q, scale)
            # server-side range update (Redis EVAL analogue): atomic per block
            block_updates[self._bkey(b)] = partial(operator.add, chunk)
            version_bumps[self._vkey(b)] = _BUMP
            applied += 1
        if block_updates:
            self.kv.eval_many(block_updates, worker=worker)
            self.kv.eval_many(version_bumps, default=0, worker=worker)
        return applied

    def current(self, worker: str = "-") -> np.ndarray:
        return self.pull(worker=worker)[0]


def _hogwild_worker(
    ps: ParameterServer,
    grad_fn: Callable[[np.ndarray, Any], np.ndarray],
    steps_per_worker: int,
    lr: float,
    arg: Tuple[int, Any],
) -> float:
    wid, shard = arg
    rng = np.random.default_rng(wid)
    last = 0.0
    for _ in range(steps_per_worker):
        params, vers = ps.pull(worker=f"psw{wid}")
        g = grad_fn(params, shard)
        ps.push_delta(-lr * g, vers, worker=f"psw{wid}", rng=rng)
        last = float(np.linalg.norm(g))
    return last


def hogwild_sgd(
    wex: WrenExecutor,
    ps: ParameterServer,
    grad_fn: Callable[[np.ndarray, Any], np.ndarray],
    data_shards: Sequence[Any],
    *,
    steps_per_worker: int = 10,
    lr: float = 0.1,
    timeout_s: float = 300.0,
) -> np.ndarray:
    """Run HOGWILD! SGD: one stateless function per data shard, each doing
    ``steps_per_worker`` async pull→grad→push iterations.  ``grad_fn`` must
    pickle by reference (a module-level function or a partial of one; a
    lambda or nested function raises ``TypeError`` when the task is
    registered)."""
    task = partial(_hogwild_worker, ps, grad_fn, steps_per_worker, lr)
    get_all(wex.map(task, list(enumerate(data_shards))), timeout_s=timeout_s)
    return ps.current()
