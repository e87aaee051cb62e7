"""Storage-backed shuffle: the paper's BSP/MapReduce data plane.

Terasort-style two-stage shuffle (§3.3):
  stage 1 (partition): each map task range/hash-partitions its input and
    writes one object per (map_task, reduce_partition) — the paper's
    2500² intermediate-file blowup, which is why request throughput (not
    bandwidth) becomes the bottleneck;
  stage 2 (merge): each reduce task reads its column of intermediates,
    merges, and writes final output.

Two intermediate backends, as in the paper: the ObjectStore (S3; abundant
bandwidth, low request throughput) and the KVStore (Redis; provisioned
shards).  Range partitioning uses sampled splitters (TeraSort's sampler).

A copy of `repro.storage.shuffle` over the port's stores.  The port's
serialization writes a list of numpy records with JAX's own descriptor, so
both packages' intermediates and sorted outputs are the same bytes on the
same roots, and either package reads the other's.

Request-count accounting (the Fig 5/6 bottleneck), both directions batched:
  * ``write_partitions`` lands a map task's entire fan-out in one batched
    write — ``ObjectStore.put_many`` (one amortized round-trip) or
    ``KVStore.mset`` (one per shard touched) — instead of one modeled
    request per (map, partition) object;
  * ``read_partition_column`` reads a reduce task's entire fan-in in one
    ``get_many``/``mget`` the same way;
  * ``delete_intermediates`` retires the whole ``shuffle/{job}`` column
    space after merge in one batched delete (``delete_many``/``mdel``), so
    intermediates don't outlive the job.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .kv_store import KVStore
from .object_store import ObjectStore

Store = Union[ObjectStore, KVStore]


def sample_splitters(
    sample: Sequence[Any], num_partitions: int, key: Optional[Callable[[Any], Any]] = None
) -> List[Any]:
    """TeraSort sampler: pick num_partitions-1 splitters from a sample so the
    output partitions are balanced."""
    if num_partitions < 1:
        raise ValueError("num_partitions >= 1")
    keys = sorted(key(x) if key else x for x in sample)
    if not keys or num_partitions == 1:
        return []
    idx = [int(len(keys) * (i + 1) / num_partitions) for i in range(num_partitions - 1)]
    return [keys[min(i, len(keys) - 1)] for i in idx]


def range_partition(
    records: Sequence[Any],
    splitters: List[Any],
    key: Optional[Callable[[Any], Any]] = None,
) -> List[List[Any]]:
    parts: List[List[Any]] = [[] for _ in range(len(splitters) + 1)]
    for rec in records:
        k = key(rec) if key else rec
        parts[bisect.bisect_right(splitters, k)].append(rec)
    return parts


def hash_partition(
    records: Sequence[Tuple[Any, Any]], num_partitions: int
) -> List[List[Tuple[Any, Any]]]:
    parts: List[List[Tuple[Any, Any]]] = [[] for _ in range(num_partitions)]
    for k, v in records:
        parts[hash(k) % num_partitions].append((k, v))
    return parts


# ---------------------------------------------------------------------------
# intermediate-file plane
# ---------------------------------------------------------------------------

def intermediate_key(job: str, map_id: int, part_id: int) -> str:
    return f"shuffle/{job}/m{map_id:06d}/p{part_id:06d}"


def gc_tombstone_key(job: str) -> str:
    """Marker that ``job``'s shuffle intermediates were GC'd.  Lives outside
    the ``shuffle/{job}/`` column space so deleting the columns can't race
    with reading the marker.  A straggler map attempt finishing after the
    merge barrier (its speculative duplicate satisfied the stage) would
    otherwise re-create just-deleted intermediates that nothing ever
    deletes again; ``write_partitions`` re-checks this marker after its
    batch lands and un-writes it.  One O(1) key per shuffle job outlives
    the GC — vs. the O(maps × partitions) leak it prevents.

    Consequence: **job ids are single-use per store** — a GC'd job name
    stays dead, and writes under it are dropped (mirroring the
    scheduler's ``finish_job`` tombstones, which drop queued duplicates
    of finished jobs the same way).  ``mapreduce``/``terasort`` mint
    uuid-suffixed ids, so this only concerns callers naming jobs by
    hand; :func:`clear_gc_tombstone` is the explicit escape hatch."""
    return f"shuffle-gc/{job}"


def clear_gc_tombstone(store: Store, job: str, *, worker: str = "-") -> None:
    """Explicitly revive a GC'd shuffle job name (job ids are single-use
    per store otherwise — see :func:`gc_tombstone_key`).  Only safe once
    no zombie attempt of the *old* job instance can still be running."""
    store.delete(gc_tombstone_key(job), worker=worker)


def write_partitions(
    store: Store,
    job: str,
    map_id: int,
    parts: Sequence[Sequence[Any]],
    *,
    worker: str = "-",
) -> int:
    """Write one intermediate object per partition; returns #objects.

    This is where the paper's quadratic request count comes from — and
    where batching attacks it: the whole map-side fan-out lands in one
    ``mset`` (KV: one round-trip per shard touched) or one ``put_many``
    (object store: one amortized round-trip), instead of one modeled
    request per partition.  The object *count* is unchanged (reducers
    still address per-(map, partition) keys); only the request count
    collapses.

    A zombie attempt (straggler whose speculative duplicate already
    satisfied the stage barrier) may run after ``delete_intermediates``
    GC'd the job; the tombstone check below un-writes its batch (returns
    0) instead of resurrecting deleted keys.  The check runs *after* the
    write on purpose — check-then-write would race (a tombstone landing
    between check and write leaves the resurrected keys forever), while
    write-then-check cannot: the tombstone is written before the GC's
    batched delete, so any write that lands after that delete must
    observe the tombstone and self-clean.  Cost: one modeled existence
    check per map task, amortized over the whole fan-out.

    Corollary: writes under a job name whose intermediates were already
    GC'd are dropped — job ids are single-use per store unless revived
    via :func:`clear_gc_tombstone`."""
    items = {
        intermediate_key(job, map_id, part_id): list(part)
        for part_id, part in enumerate(parts)
    }
    tomb = gc_tombstone_key(job)
    if isinstance(store, KVStore):
        store.mset(items, worker=worker)
        if store.exists(tomb, worker=worker):
            store.mdel(list(items), worker=worker)
            return 0
    else:
        store.put_many(items, worker=worker)
        if store.exists(tomb, worker=worker):
            store.delete_many(list(items), worker=worker)
            return 0
    return len(items)


def read_partition_column(
    store: Store,
    job: str,
    num_map_tasks: int,
    part_id: int,
    *,
    worker: str = "-",
) -> List[Any]:
    """Reduce-side: read intermediates from every map task for one partition.

    Batched — one ``mget`` (KV: one round-trip per shard touched) or one
    ``get_many`` (object store: one amortized round-trip) for the whole
    column, instead of ``num_map_tasks`` synchronous gets.  This is the
    fan-in the paper's Fig 5/6 sort saturates on; batching attacks the
    request count, not just the byte count."""
    keys = [intermediate_key(job, map_id, part_id) for map_id in range(num_map_tasks)]
    if isinstance(store, KVStore):
        chunks = store.mget(keys, default=[], worker=worker)
    else:
        got = store.get_many(keys, worker=worker)
        chunks = [got.get(k, []) for k in keys]
    out: List[Any] = []
    for chunk in chunks:
        out.extend(chunk)
    return out


def delete_intermediates(
    store: Store,
    job: str,
    num_map_tasks: int,
    num_partitions: int,
    *,
    worker: str = "-",
) -> int:
    """Shuffle-intermediate GC: retire every ``shuffle/{job}`` object after
    the merge stage has consumed them.  The key space is deterministic
    (``intermediate_key`` over the map × partition grid), so no listing is
    needed — the whole column space goes in one batched delete
    (``KVStore.mdel``: one round-trip per shard touched;
    ``ObjectStore.delete_many``: one amortized round-trip).  A GC
    tombstone (:func:`gc_tombstone_key`) is written *before* the deletes
    so a zombie map attempt landing afterwards sees it and drops its
    re-write.  Returns the number of keys submitted for deletion."""
    keys = [
        intermediate_key(job, map_id, part_id)
        for map_id in range(num_map_tasks)
        for part_id in range(num_partitions)
    ]
    if not keys:
        return 0
    if isinstance(store, KVStore):
        store.set(gc_tombstone_key(job), 1, worker=worker)
        store.mdel(keys, worker=worker)
    else:
        store.put(gc_tombstone_key(job), 1, worker=worker)
        store.delete_many(keys, worker=worker)
    return len(keys)


def merge_sorted(chunks: List[List[Any]], key: Optional[Callable[[Any], Any]] = None) -> List[Any]:
    import heapq

    return list(heapq.merge(*[sorted(c, key=key) for c in chunks], key=key))


def make_sort_records(n: int, seed: int, payload_bytes: int = 90) -> np.ndarray:
    """Daytona-sort-style records: 10-byte key + payload, as uint8 rows."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, 256, size=(n, 10 + payload_bytes), dtype=np.uint8)
    return recs


def record_sort_key(rec: np.ndarray) -> bytes:
    return rec[:10].tobytes()
