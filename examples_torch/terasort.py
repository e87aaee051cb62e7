"""BSP shuffle: the Daytona-sort workload (paper §3.3, Figs 5/6), on the
PyTorch port's runtime (the twin of ``examples/terasort.py``).

Two-stage TeraSort over stateless functions with Redis-class intermediate
storage; sweeps Redis shard counts to reproduce the paper's bottleneck
analysis ('fully leveraging this parallelism requires more Redis shards').
The shuffle's range partitioner is loss-free and ordered across partitions:

>>> from repro_torch.storage import shuffle as shf
>>> splitters = shf.sample_splitters([5, 1, 9, 3, 7], 2)
>>> parts = shf.range_partition([5, 1, 9, 3, 7], splitters)
>>> sorted(x for p in parts for x in p)
[1, 3, 5, 7, 9]
>>> max(parts[0]) <= min(parts[1])
True

The runtime is host code (numpy on worker threads); no device is used.

Run:  PYTHONPATH=src python examples_torch/terasort.py
"""

import time

from repro_torch.core import WrenExecutor, terasort, verify_sorted
from repro_torch.storage import KVStore, REDIS_2017, S3_2017, ObjectStore
from repro_torch.storage import shuffle as shf

N_FILES, RECS_PER_FILE, N_PARTS = 10, 500, 10
SHARDS = (1, 4, 8)


def sort_with(shards: int) -> dict:
    """One sort over ``shards`` Redis-class shards -> its printed numbers
    and the sorted partitions' bytes by key."""
    store = ObjectStore(profile=S3_2017)
    wex = WrenExecutor(store=store, num_workers=6)
    try:
        keys = []
        for i in range(N_FILES):
            key = f"input/part{i:04d}"
            store.put(key, shf.make_sort_records(RECS_PER_FILE, seed=i), worker="gen")
            keys.append(key)

        kv = KVStore(num_shards=shards, profile=REDIS_2017)
        t0 = time.perf_counter()
        report = terasort(wex, keys, f"sorted/{shards}", N_PARTS, intermediate=kv)
        wall = time.perf_counter() - t0
        ok = verify_sorted(store, f"sorted/{shards}")
        print(
            f"shards={shards}: sorted {report.n_records} records "
            f"({report.n_intermediate_objects} intermediate objects = "
            f"{N_FILES}x{N_PARTS}), globally ordered: {ok}, "
            f"hottest-shard virtual time {report.hottest_shard_vtime:.3f}s, "
            f"wall {wall:.2f}s"
        )
        parts = {k: store.get_bytes(k) for k in store.list(f"sorted/{shards}/")}
    finally:
        wex.shutdown()
    return {"n_records": report.n_records,
            "n_intermediate_objects": report.n_intermediate_objects, "sorted_ok": ok,
            "hottest_shard_vtime": report.hottest_shard_vtime, "wall_s": wall, "parts": parts}


def main() -> dict:
    """-> {shard count: sort_with(shard count)}."""
    rows = {shards: sort_with(shards) for shards in SHARDS}
    print("note the quadratic intermediate-object count and the hotspot "
          "relief from added shards — the paper's Fig 5/6 story")
    return rows


if __name__ == "__main__":
    main()
