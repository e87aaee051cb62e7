"""Net cluster: the whole runtime over a live ``repro-kvd`` daemon, on the
PyTorch port (the twin of ``examples/net_cluster.py``).

The file substrate shares one machine's disk; this example runs the same
stack over a storage *service* — the shape the paper assumes, where
S3 and Redis are endpoints every Lambda dials into.  ``repro-kvd``
(``repro_torch.storage.net_server``) owns the log-structured shard files
exclusively and serves both planes over one wire protocol;
``NetKVStore``/``NetBackend`` preserve the full behavioural contract
(batched-verb charging, pushed watched-key wakes, the eval replay rule),
so ``WrenExecutor`` cannot tell the difference:

>>> import tempfile
>>> from repro_torch.storage import NetBackend, NetKVStore, ObjectStore
>>> from repro_torch.storage.net_server import KVDServer
>>> tmp = tempfile.mkdtemp()
>>> srv = KVDServer(tmp + "/data", f"unix:{tmp}/kvd.sock",
...                 fsync="never").start()
>>> a = NetKVStore(srv.address)            # two clients, one server —
>>> b = NetKVStore(srv.address)            # e.g. two driver processes
>>> a.rpush("sched/queue", "task-0")
1
>>> b.lpop("sched/queue")                  # one shared queue
'task-0'
>>> a.close(); b.close(); srv.close()

A **shard map** scales the service horizontally: N daemons, one
ordered map every client shares — map order *is* the topology (it fixes
the key → daemon hash ring and the global shard numbering).  Keys hash
across the daemons, batched verbs scatter to every involved daemon in
parallel, and one daemon's outage degrades only its own shards:

>>> srv_a = KVDServer(tmp + "/a", f"unix:{tmp}/a.sock", fsync="never").start()
>>> srv_b = KVDServer(tmp + "/b", f"unix:{tmp}/b.sock", fsync="never").start()
>>> kv = NetKVStore([srv_a.address, srv_b.address])  # ORDER IS THE TOPOLOGY
>>> kv.mset({f"k/{i}": i for i in range(64)})        # one scatter, both daemons
>>> sorted({kv._daemon_of(f"k/{i}") for i in range(64)})  # both really own keys
[0, 1]
>>> kv.mget(["k/3", "k/33"])
[3, 33]
>>> kv.close(); srv_a.close(); srv_b.close()

Below, the daemon runs as a real subprocess (the CLI a deployment uses),
two drivers dial in over TCP and cooperate on one mapreduce, and then the
server is SIGKILLed mid-map and restarted: clients reconnect, re-register
their watches on the new server generation, resend in-flight requests,
and the job completes with exact results — the recovery contract
``tests/test_torch_net_kill.py`` pins.  The kill lands after the map's
first result and before its last (each task takes a few milliseconds), so
the clients really do reconnect.  The mapped function is module-level
(the port ships it with the standard ``pickle``).  The runtime is host
code; no device is used.

Run:  PYTHONPATH=src python examples_torch/net_cluster.py
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from repro_torch.core import ANY_COMPLETED, WrenExecutor, get_all, wait, word_count
from repro_torch.storage import NetBackend, NetKVStore, ObjectStore

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

DOCS = [
    "the cloud is just someone else us computer".split(),
    "occupy the cloud distributed computing for the rest of us".split(),
    "the simplicity of a map over stateless functions".split(),
    "storage is the only channel between functions".split(),
] * 4  # 16 map partitions
N_SQUARES = 32
SQUARE_S = 0.05  # each squaring task's own time: the map outlives the kill


def square(x: int) -> int:
    time.sleep(SQUARE_S)
    return x * x


def spawn_kvd(root: str, port: int) -> subprocess.Popen:
    """The deployment entry point: ``python -m repro_torch.storage.net_server``."""
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.storage.net_server",
            "--root", root, "--port", str(port), "--fsync", "never",
        ],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": _SRC},
    )
    banner = proc.stdout.readline().strip()
    assert banner.startswith("LISTENING"), banner
    return proc


def main() -> dict:
    """-> {"counts": the word counts, "b_tasks": driver B's tasks,
    "done_at_kill": squaring results published just before the SIGKILL,
    "results": the squares, "reconnects": the client's reconnects}."""
    with tempfile.TemporaryDirectory() as root:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        proc = spawn_kvd(f"{root}/kvd", port)
        addr = f"127.0.0.1:{port}"

        kv = NetKVStore(addr)
        store = ObjectStore(backend=NetBackend(addr))
        driver_a = WrenExecutor(store=store, kv=kv, num_workers=2, seed=1)
        driver_b = WrenExecutor(store=store, kv=kv, num_workers=2, seed=2)
        try:
            # Two drivers, one daemon: B's workers lease tasks of the job
            # only A submitted, exactly as over the shared-disk substrate.
            counts = word_count(driver_a, [[" ".join(d)] for d in DOCS], num_reducers=4)
            top = sorted(counts.items(), key=lambda kv_: -kv_[1])[:3]
            print(f"word count over {len(DOCS)} partitions: top {top}")
            b_done = sum(s.tasks_ok for s in driver_b.pool.stats().values())
            print(f"driver B executed {b_done} tasks of A's job")

            # Kill the daemon mid-map, after the first result and before
            # the last; restart it; the map still completes.
            futs = driver_a.map(square, list(range(N_SQUARES)))
            wait(futs, return_when=ANY_COMPLETED, timeout_s=60)
            done_at_kill = sum(f.done() for f in futs)  # a dead daemon would block this
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            print(f"SIGKILLed repro-kvd mid-map ({done_at_kill} of {N_SQUARES} results "
                  "published); restarting on the same root")
            assert done_at_kill < N_SQUARES, "the map ended before the kill"
            proc = spawn_kvd(f"{root}/kvd", port)
            results = get_all(futs, timeout_s=120)
            assert results == [x * x for x in range(N_SQUARES)]
            reconnects = kv._client.reconnects
            print(f"map of {N_SQUARES} tasks survived the restart "
                  f"(client reconnects: {reconnects})")
            assert reconnects >= 1, "no client reconnected to the restarted daemon"
        finally:
            driver_a.shutdown()
            driver_b.shutdown()
            kv.close()
            store.backend.close()
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=10)
    return {"counts": counts, "b_tasks": b_done, "done_at_kill": done_at_kill,
            "results": results, "reconnects": reconnects}


if __name__ == "__main__":
    main()
