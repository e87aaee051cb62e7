"""Multi-driver: two stateless drivers cooperate on one mapreduce, on the
PyTorch port's runtime (the twin of ``examples/multi_driver.py``).

The scheduler is a *handle over the KV*, not a server: any number of
drivers sharing a store/KV pair work one queue, and fenced epoch leases
keep their concurrent reap/speculate/complete transitions exactly-once.
Here both the storage planes are **file-backed** (`FileBackend` +
`FileKVStore`), the substrate that also works across real OS processes —
driver B could be another process on the same filesystem and nothing below
would change (`tests/test_torch_storage.py` runs that topology with a
spawned subprocess pool; the cross-process wake is the log-file watch
described in docs/ARCHITECTURE.md).  The file KV is log-structured: two
handles over one directory see one keyspace, and each mutation is one
appended record, not a shard rewrite:

>>> import tempfile
>>> from repro_torch.storage import FileKVStore
>>> root = tempfile.mkdtemp()
>>> a = FileKVStore(root, num_shards=1)   # "driver A"
>>> b = FileKVStore(root, num_shards=1)   # "driver B", same directory
>>> a.rpush("sched/queue", "task-0", worker="A")
1
>>> b.lpop("sched/queue", worker="B")     # B replays A's appended frame
'task-0'
>>> a.close(); b.close()

Driver A submits a word-count mapreduce; driver B never sees the submit —
its workers lease map and reduce tasks straight off the shared queue, and
its control loop reaps/speculates the same job.  The runtime is host code;
no device is used.

Run:  PYTHONPATH=src python examples_torch/multi_driver.py
"""

import tempfile

from repro_torch.core import WrenExecutor, word_count
from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

DOCS = [
    "the cloud is just someone else us computer".split(),
    "occupy the cloud distributed computing for the rest of us".split(),
    "the simplicity of a map over stateless functions".split(),
    "storage is the only channel between functions".split(),
] * 4  # 16 map partitions


def main() -> dict:
    """-> {"counts": the word counts, "tasks": {driver: tasks executed}}."""
    with tempfile.TemporaryDirectory() as root:
        store = ObjectStore(backend=FileBackend(f"{root}/obj"))
        kv = FileKVStore(f"{root}/kv", num_shards=2)

        # Two independent drivers: each has its own scheduler handle and
        # worker pool, but every byte of control-plane state they act on
        # lives in the shared KV/store.
        driver_a = WrenExecutor(store=store, kv=kv, num_workers=2, seed=1)
        driver_b = WrenExecutor(store=store, kv=kv, num_workers=2, seed=2)
        try:
            # Driver A runs the job; driver B's workers just... find work.
            counts = word_count(driver_a, [[" ".join(d)] for d in DOCS], num_reducers=4)
            top = sorted(counts.items(), key=lambda kv_: -kv_[1])[:3]
            print(f"word count over {len(DOCS)} partitions: top {top}")

            tasks = {}
            for name, wex in (("A", driver_a), ("B", driver_b)):
                tasks[name] = sum(s.tasks_ok for s in wex.pool.stats().values())
                print(f"driver {name} executed {tasks[name]} tasks")
            assert tasks["B"] > 0, "driver B never leased from the shared queue"
            print("both drivers executed tasks of a job only A submitted")
        finally:
            driver_a.shutdown()
            driver_b.shutdown()
            kv.close()
            store.backend.close()
    return {"counts": counts, "tasks": tasks}


if __name__ == "__main__":
    main()
