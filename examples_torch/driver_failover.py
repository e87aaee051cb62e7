"""Driver failover: SIGKILL the submitting driver mid-mapreduce; adopt it.
On the PyTorch port's runtime (the twin of ``examples/driver_failover.py``).

The *job* plane lives in the KV: a manifest under ``sched/job/{job}``
records the stage graph, per-stage plans, and barrier outputs, all written
first-writer-wins, while the submitting driver holds a term-fenced
**driver lease** it heartbeats from its control loop.  A driver that dies
simply stops heartbeating; any other handle detects the lapsed lease,
fences a takeover at ``term + 1``, and *replays* the manifest — recorded
barriers return instantly, so only the unfinished suffix of the job runs.

The lease fencing in two lines — a release keeps the record (term intact),
so the next owner always draws a strictly higher term and the dead
driver's in-flight heartbeats fail:

>>> from repro_torch.core import jobs
>>> from repro_torch.storage import KVStore
>>> kv = KVStore(num_shards=1)
>>> jobs.acquire_driver(kv, "job", "drv-A", 30.0)["term"]   # first owner
1
>>> jobs.release_driver(kv, "job", "drv-A", 1)              # expire, keep record
True
>>> jobs.acquire_driver(kv, "job", "drv-B", 30.0)["term"]   # takeover: term + 1
2
>>> jobs.heartbeat_drivers(kv, {"job": 1}, "drv-A", 30.0)   # zombie: fenced out
['job']

Below, a *real* subprocess driver submits a word-count mapreduce over
shared ``FileKVStore``/``FileBackend`` directories and is SIGKILLed the
instant its map barrier commits — between the map and reduce stages, the
worst moment short of mid-barrier.  This process waits out the driver
lease, adopts, and finishes: the map stage is skipped (its barrier is
recorded), only the reduce stage runs, and the terminal GC leaves the
``sched/job/`` and ``shuffle/`` keyspaces empty.

The port ships the map and reduce functions with the standard ``pickle``,
by reference: the manifest names ``__main__._map_fn``, which the adopter
resolves because it runs this same file as ``__main__``.  So run it as a
script, as below.  The runtime is host code; no device is used.

Run:  PYTHONPATH=src python examples_torch/driver_failover.py
"""

import os
import signal
import subprocess
import sys
import tempfile

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

DOCS = [
    "the cloud is just someone else us computer".split(),
    "occupy the cloud distributed computing for the rest of us".split(),
    "no process is special not even the driver".split(),
    "storage is the only channel between functions".split(),
] * 4  # 16 map partitions
JOB = "failover-demo"
NUM_REDUCERS = 4


def _map_fn(doc):
    return [(w, 1) for w in doc]


def _reduce_fn(_word, counts):
    return sum(counts)


def submit_and_die(kv_root: str, obj_root: str) -> None:
    """Subprocess entry: submit the mapreduce, then SIGKILL ourselves the
    instant the map barrier commits — no release, no cleanup, exactly what
    a crashed driver leaves behind."""
    from repro_torch.core import SchedulerConfig, WrenExecutor, bsp
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    kv = FileKVStore(kv_root, num_shards=2)
    store = ObjectStore(backend=FileBackend(obj_root))
    wex = WrenExecutor(
        store=store, kv=kv, num_workers=2,
        scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0),
    )

    orig_barrier = bsp._stage_barrier

    def dying_barrier(wex_, job, idx, plan, outputs, **kw):
        out = orig_barrier(wex_, job, idx, plan, outputs, **kw)
        if idx == 0:  # the map barrier just committed: die now
            print(f"[child] map barrier committed for {job!r}; SIGKILL", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    bsp._stage_barrier = dying_barrier
    bsp.mapreduce(wex, _map_fn, _reduce_fn, DOCS, NUM_REDUCERS, job_id=JOB)


def main() -> dict:
    """-> {"child_returncode", "counts": the adopted job's word counts,
    "gc_empty": the job's keyspaces were empty after GC}."""
    from repro_torch.core import SchedulerConfig, WrenExecutor, adopt_job
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    with tempfile.TemporaryDirectory() as root:
        kv_root, obj_root = f"{root}/kv", f"{root}/obj"
        env = dict(os.environ, PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "child", kv_root, obj_root],
            env=env,
        )
        child.wait(timeout=120)
        assert child.returncode == -signal.SIGKILL, "child was supposed to die by SIGKILL"
        print("[parent] child driver died (SIGKILL) mid-job")

        kv = FileKVStore(kv_root, num_shards=2)
        store = ObjectStore(backend=FileBackend(obj_root))
        wex = WrenExecutor(
            store=store, kv=kv, num_workers=2,
            scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0),
        )
        try:
            # detect (wait out the dead driver's lease) → fence → replay.
            counts = adopt_job(wex, JOB, wait_timeout_s=30.0)
            top = sorted(counts.items(), key=lambda kv_: -kv_[1])[:3]
            print(f"[parent] adopted and finished {JOB!r}: top {top}")
            print(f"[parent] counts {sorted(counts.items())}")
            assert counts["the"] == 20, counts  # 5 per 4-doc block x 4 blocks
            # the terminal GC left no trace: manifest and shuffle gone
            gc_empty = kv.scan(f"sched/job/{JOB}/") == [] and store.list("shuffle/") == []
            assert gc_empty, (kv.scan(f"sched/job/{JOB}/"), store.list("shuffle/"))
            print("[parent] sched/job/ and shuffle/ keyspaces empty after GC")
        finally:
            wex.shutdown()
            kv.close()
            store.backend.close()
    return {"child_returncode": child.returncode, "counts": counts, "gc_empty": gc_empty}


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "child":
        submit_and_die(sys.argv[2], sys.argv[3])
    else:
        main()
