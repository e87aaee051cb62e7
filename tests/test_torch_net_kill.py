"""Crash recovery of the port's ``repro-kvd`` (`tests/test_net_kill.py`'s
twin): SIGKILL the daemon under live traffic and pin the recovery
contract.

The server is a real subprocess (``python -m
repro_torch.storage.net_server``, the port's CLI), killed with SIGKILL so
nothing gets to flush, unwind, or say goodbye, then restarted over the
same root and address.  Each daemon start waits at most
``START_TIMEOUT_S`` for its ``LISTENING`` line (a start imports torch),
each stop ``STOP_TIMEOUT_S``.  The pins:

  * **acknowledged writes survive** — any op the client saw complete is
    in the store after restart (the shard logs append before the server
    replies; a SIGKILL loses at most the unacknowledged suffix);
  * **batch atomicity holds across the kill** — a same-shard batched
    write is one log transaction: after recovery it is all-there or
    not-there, never half;
  * **clients reconnect and resync transparently** — in-flight calls
    block through the outage and complete against the new server
    (at-least-once resend; see net_kv's module docstring for where
    exactly-once is layered on top);
  * **no lost wakeups** — a ``blpop`` waiter blocked across the restart
    is woken by a push from a *different* client against the new server
    generation (its per-key watch was re-registered on reconnect);
  * **the executor stack rides it out** — a ``WrenExecutor`` map whose
    control plane lives on the killed server still returns exactly its
    results, no losses, no duplicates;
  * **a dead driver's job is adopted over the wire** — a terasort driver
    SIGKILLed at its partition barrier is adopted by this process, whose
    workers reach the dead driver's intermediates through its ``net_kv``
    reconnect spec; only the merge tasks run.

Reconnects are counted from the server generations a client was handed
(``NetClient.generations``): each test talks to every generation it
starts before it kills it, so a restart cannot go uncounted (JAX's twin
counts redials, which two kills inside one idle stretch fold into one).

Churn payloads are sized to force log compaction (64 KiB per-shard
threshold) while the kill lands, so the mid-compaction crash path — the
generation-rename dance in ``file_kv`` — is exercised, not just the
append path.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.storage import NetBackend, NetKVStore, ObjectStore  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_TESTS, os.pardir, "src"))
START_TIMEOUT_S = 60
STOP_TIMEOUT_S = 10


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Server:
    """The repro-kvd subprocess, killable and restartable in place (same
    root, same port — what a supervisor like systemd would do)."""

    def __init__(self, root: str, port: int) -> None:
        self.root = root
        self.port = port
        self.proc = None

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "_Server":
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "repro_torch.storage.net_server",
                "--root", self.root, "--port", str(self.port),
                "--num-shards", "4", "--fsync", "never",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        line = []
        reader = threading.Thread(target=lambda: line.append(self.proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(START_TIMEOUT_S)
        if not line or not line[0].startswith("LISTENING"):
            self.proc.kill()
            self.proc.wait(timeout=STOP_TIMEOUT_S)
            raise AssertionError(f"server failed to start in {START_TIMEOUT_S} s: {line!r}")
        return self

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=STOP_TIMEOUT_S)

    def stop(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=STOP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=STOP_TIMEOUT_S)


@pytest.fixture
def server(tmp_path):
    srv = _Server(str(tmp_path / "kvd"), _free_port()).start()
    yield srv
    srv.stop()


def _same_shard_keys(kv, batch: int, n: int):
    """``n`` keys for ``batch`` that all live in one shard, so a batched
    write of them is a single log transaction (the atomicity unit)."""
    sidx = kv.shard_of(f"batch/{batch}/0")
    keys, i = [], 0
    while len(keys) < n:
        k = f"batch/{batch}/{i}"
        if kv.shard_of(k) == sidx:
            keys.append(k)
        i += 1
    return keys


def test_kill_mid_churn_acknowledged_writes_survive(server):
    """Sequential writer churns fat values (forcing compactions); SIGKILL
    lands mid-stream; the writer's in-flight call completes against the
    restarted server and every acknowledged write is still there."""
    kv = NetKVStore(server.address)
    n, payload = 300, "x" * 2048  # ~600 KiB through 4 shards: compacts often
    acked = []
    failures = []

    def writer():
        try:
            for i in range(n):
                kv.set(f"seq/{i}", (i, payload))
                acked.append(i)
        except Exception as exc:  # pragma: no cover - surfaced below
            failures.append(exc)

    t = threading.Thread(target=writer)
    t.start()
    while len(acked) < 40:
        time.sleep(0.005)
    server.kill()
    time.sleep(0.15)
    server.start()
    t.join(timeout=60)
    assert not t.is_alive(), "writer wedged across the restart"
    assert not failures, failures
    assert len(acked) == n  # every call completed, outage included
    got = kv.mget([f"seq/{i}" for i in range(n)])
    assert got == [(i, payload) for i in range(n)]
    assert len(kv._client.generations) == 2 and kv._client.reconnects >= 1
    kv.close()


def test_kill_mid_batches_every_acked_batch_whole(server):
    """Batched same-shard writes across TWO kill/restart cycles: after
    recovery, acknowledged batches are fully present, and no batch is
    half-present (one log transaction each)."""
    kv = NetKVStore(server.address)
    n_batches, width, payload = 120, 4, "y" * 1024
    acked = set()
    failures = []

    def writer():
        try:
            for b in range(n_batches):
                keys = _same_shard_keys(kv, b, width)
                kv.mset({k: (b, payload) for k in keys})
                acked.add(b)
        except Exception as exc:  # pragma: no cover
            failures.append(exc)

    t = threading.Thread(target=writer)
    t.start()
    for threshold in (20, 60):
        while len(acked) < threshold and t.is_alive():
            time.sleep(0.005)
        server.kill()
        time.sleep(0.15)
        server.start()
        kv.get("probe")  # this client talks to the new generation before the next kill
    t.join(timeout=60)
    assert not t.is_alive() and not failures, failures
    assert acked == set(range(n_batches))
    for b in range(n_batches):
        keys = _same_shard_keys(kv, b, width)
        got = kv.mget(keys, default=None)
        present = [v for v in got if v is not None]
        assert len(present) in (0, width), f"batch {b} half-applied: {got}"
        assert len(present) == width  # it was acked, so it must be whole
        assert all(v == (b, payload) for v in present)
    # the first daemon and both restarts, each seen: neither kill uncounted
    assert len(kv._client.generations) == 3 and kv._client.reconnects >= 2
    kv.close()


def test_blpop_waiter_survives_restart_no_lost_wakeup(server):
    """A consumer blocked in ``blpop`` before the kill is woken by a push
    from a DIFFERENT client against the restarted server: its per-key
    watch was re-registered on the new generation during reconnect."""
    kv = NetKVStore(server.address)
    for i in range(50):
        kv.set(f"pre/{i}", i)
    got = {}

    def popper():
        got["v"] = kv.blpop("killq", timeout_s=30.0)

    t = threading.Thread(target=popper)
    t.start()
    time.sleep(0.3)  # waiter registered and blocked
    server.kill()
    time.sleep(0.15)
    server.start()
    # late ops complete transparently; the committed prefix survived
    kv.set("post", "yes")
    assert kv.get("post") == "yes"
    assert kv.mget([f"pre/{i}" for i in range(50)]) == list(range(50))
    # the push comes from a FRESH client: only the re-registered watch on
    # the new server can route this wake to the old waiter
    kv2 = NetKVStore(server.address)
    kv2.rpush("killq", "survived")
    t.join(timeout=30)
    assert got.get("v") == "survived"
    assert len(kv._client.generations) == 2 and kv._client.reconnects >= 1
    kv2.close()
    kv.close()


def _first_key(kv, daemon, prefix):
    i = 0
    while True:
        k = f"{prefix}/{i}"
        if kv._daemon_of(k) == daemon:
            return k
        i += 1


def test_shard_map_kill_one_daemon_partial_outage(tmp_path):
    """SIGKILL one daemon of a 2-daemon shard map under churn.  The pins:
    ops on the surviving daemon's shards stay live through the outage
    (independent connections — one daemon's crash degrades only its own
    shards), acknowledged writes on the killed daemon's shards are all
    present after restart, and watch re-registration wakes waiters on both
    sides of the partial outage."""
    srv_a = _Server(str(tmp_path / "a"), _free_port()).start()
    srv_b = _Server(str(tmp_path / "b"), _free_port()).start()
    shard_map = f"{srv_a.address},{srv_b.address}"
    kv = NetKVStore(shard_map)
    kv2 = NetKVStore(shard_map)  # the waker: a different client
    try:
        all_keys = [f"k/{i}" for i in range(120)]
        a_keys = [k for k in all_keys if kv._daemon_of(k) == 0]
        b_keys = [k for k in all_keys if kv._daemon_of(k) == 1]
        assert len(a_keys) > 10 and len(b_keys) > 10  # the map really splits
        aq = _first_key(kv, 0, "q")  # queue key on the surviving daemon
        bq = _first_key(kv, 1, "p")  # queue key on the daemon we kill
        payload = "z" * 2048  # fat enough to force compactions server-side

        acked = []
        failures = []

        def writer():
            try:
                for i in range(600):
                    k = all_keys[i % len(all_keys)]
                    kv.set(k, (i, payload))
                    acked.append(i)
                    time.sleep(0.002)
            except Exception as exc:  # pragma: no cover - surfaced below
                failures.append(exc)

        wt = threading.Thread(target=writer)
        wt.start()
        # a waiter on the doomed daemon's shard, blocked BEFORE the kill
        b_got = {}
        bt = threading.Thread(
            target=lambda: b_got.update(v=kv.blpop(bq, timeout_s=60.0))
        )
        bt.start()
        while len(acked) < 40:
            time.sleep(0.005)
        time.sleep(0.2)  # the blpop watch is registered by now
        srv_b.kill()
        # --- during the outage: the surviving daemon never blocks --------
        t0 = time.monotonic()
        probe = _first_key(kv, 0, "live")  # owned by the surviving daemon
        kv.set(probe, "up")
        assert kv.get(probe) == "up"
        assert all(
            v is None or v[1] == payload for v in kv.mget(a_keys, default=None)
        )
        assert time.monotonic() - t0 < 2.0, "surviving shards stalled"
        # a waiter on the surviving daemon is woken DURING the outage
        a_got = {}
        at = threading.Thread(
            target=lambda: a_got.update(v=kv.blpop(aq, timeout_s=15.0))
        )
        at.start()
        time.sleep(0.3)
        kv2.rpush(aq, "live")
        at.join(timeout=15)
        assert a_got.get("v") == "live"
        # --- restart: the killed daemon's shards recover ------------------
        srv_b.start()
        wt.join(timeout=120)
        assert not wt.is_alive(), "writer wedged across the partial outage"
        assert not failures, failures
        assert len(acked) == 600  # every call completed, outage included
        got = kv.mget(all_keys)
        expect = [(480 + j, payload) for j in range(120)]  # the final cycle
        assert got == expect
        # the waiter blocked across the restart is woken by a fresh push:
        # its watch was re-registered on the new server generation
        kv2.rpush(bq, "back")
        bt.join(timeout=30)
        assert b_got.get("v") == "back"
        # reconnects stayed per-daemon: only the killed daemon's client redialed
        assert kv._clients[1].reconnects >= 1 and len(kv._clients[1].generations) == 2
        assert kv._clients[0].reconnects == 0 and len(kv._clients[0].generations) == 1
    finally:
        kv2.close()
        kv.close()
        srv_a.stop()
        srv_b.stop()


def test_executor_map_exact_results_across_kill(server):
    """End to end: a WrenExecutor map whose whole control plane (queues,
    leases, results) lives on the killed server still produces exactly
    its results — nothing lost to the outage, nothing duplicated (task
    effects are exactly-once over at-least-once wire ops: deterministic
    task ids, epoch-fenced leases, ``if_absent`` result publishes)."""
    from repro_torch.core import WrenExecutor, get_all

    kv = NetKVStore(server.address)
    store = ObjectStore(backend=NetBackend(server.address))
    with WrenExecutor(store=store, kv=kv, num_workers=4) as wex:
        wex.map_get(_identity, [0], timeout_s=60)  # warm containers
        futs = wex.map(_triple, list(range(48)))
        time.sleep(0.2)  # mid-flight
        server.kill()
        time.sleep(0.15)
        server.start()
        results = get_all(futs, timeout_s=120)
    assert results == [x * 3 for x in range(48)]
    assert len(kv._client.generations) == 2 and kv._client.reconnects >= 1
    store.backend.close()
    kv.close()


def _identity(x):
    return x


def _triple(x):
    return x * 3


def _sort_driver_main(address):
    """Child entry: a terasort over the daemon at ``address``, this process
    SIGKILLed the instant the partition barrier commits."""
    from repro_torch.core import SchedulerConfig, WrenExecutor, bsp

    kv = NetKVStore(address)
    store = ObjectStore(backend=NetBackend(address))
    wex = WrenExecutor(store=store, kv=kv, num_workers=2,
                       scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0))
    orig = bsp._stage_barrier

    def killing_barrier(wex_, job, idx, plan, outputs, **kw):
        out = orig(wex_, job, idx, plan, outputs, **kw)
        if idx == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    bsp._stage_barrier = killing_barrier
    rng = np.random.default_rng(7)
    keys = []
    for i in range(3):
        store.put(f"sortin/part{i}", rng.integers(0, 256, size=(40, 100), dtype=np.uint8))
        keys.append(f"sortin/part{i}")
    bsp.terasort(wex, keys, "sorted", num_partitions=4, intermediate=kv, job_id="net-sort")
    raise SystemExit("the driver survived its kill barrier")


def test_sigkilled_sort_driver_is_adopted_through_net_specs(server):
    """7c of ``chip_smoke.py`` over the wire, on the CPU: the merge tasks
    the dead driver planned carry its KV handle (the intermediates), which
    this process rebuilds from its ``net_kv`` spec."""
    from repro_torch.core import SchedulerConfig, WrenExecutor, adopt_job, verify_sorted
    from repro_torch.storage import object_store

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, _TESTS, os.environ.get("PYTHONPATH", "")]))
    code = f"import test_torch_net_kill as t; t._sort_driver_main({server.address!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9, proc.stdout + proc.stderr
    kv = NetKVStore(server.address)
    store = ObjectStore(backend=NetBackend(server.address))
    wex = WrenExecutor(store=store, kv=kv, num_workers=2,
                       scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0))
    try:
        submits = []
        orig = wex.scheduler.submit_many
        wex.scheduler.submit_many = lambda tasks: submits.append(len(tasks)) or orig(tasks)
        report = adopt_job(wex, "net-sort", wait_timeout_s=30.0, timeout_s=120.0)
        assert report is not None and report.n_records == 3 * 40
        assert sum(submits) == 4  # only the merge tasks
        assert verify_sorted(store, "sorted")
        outs = np.concatenate([store.get(k) for k in store.list("sorted")])
        ins = np.concatenate([store.get(f"sortin/part{i}") for i in range(3)])
        assert sorted(map(bytes, outs)) == sorted(map(bytes, ins))
        assert kv.scan("sched/job/net-sort/") == [] and kv.scan("shuffle/") == []
        # the merge tasks' intermediate store: the dead driver's handle,
        # rebuilt here from its spec
        assert ("net_kv", server.address) in object_store._RECONNECT_CACHE
    finally:
        wex.shutdown()
        store.backend.close()
        kv.close()
