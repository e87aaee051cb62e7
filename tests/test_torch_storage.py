"""The port's storage plane (`repro_torch.storage`) and its runtime over the
file stores, on the CPU.

The behaviour held here is the JAX package's, from
`tests/test_backend_conformance.py` (its in-memory and file cases),
`tests/test_filekv_crash.py` and the cross-process map of
`tests/test_multidriver.py`:

  * one contract over three substrates, ``memory`` (``KVStore`` and the
    in-memory backend), ``file-log`` and ``file-snapshot`` (``FileKVStore``
    with each engine, ``FileBackend``): batched verbs charged once per
    shard touched, one sequence bump per shard per batch, first writer
    wins, destructive reads hand each element out once, cross-handle waits
    wake with no fallback tick;
  * crash safety of the log engine: a SIGKILLed writer leaves exactly its
    committed prefix; torn tails are dropped and truncated; the compaction
    crash window reads back identically; the inotify watcher wakes with
    zero timed polls;
  * handles pickled into a task reopen in another process from their
    reconnect spec; the port's `WrenExecutor` runs a map whose tasks a
    worker pool in another process executes, with zero fallback ticks; the
    elastic trainer resumes in a fresh process with bit-equal losses.

Each subprocess has its own timeout of about 30 s.
"""

import glob
import os
import pickle
import signal
import struct
import subprocess
import sys
import threading
import time
import zlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.storage import (  # noqa: E402
    DELETE,
    FileBackend,
    FileKVStore,
    KVStore,
    ObjectStore,
)
from repro_torch.storage import object_store as tos  # noqa: E402
from repro_torch.storage.kv_store import (  # noqa: E402
    BUF_FLAG,
    LOG_MAGIC,
    MAX_FRAME_LEN,
    decode_log_header,
    encode_frame,
    encode_log_header,
    iter_frames,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SUBPROCESS_TIMEOUT_S = 30
BACKENDS = ("memory", "file-log", "file-snapshot")


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _spawn(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(proc, what):
    try:
        out = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"{what} did not finish in {SUBPROCESS_TIMEOUT_S} s")
    assert proc.returncode == 0, f"{what} exited {proc.returncode}: {out.decode()[-3000:]}"
    return out.decode()


# ---------------------------------------------------------------------------
# conformance over three substrates
# ---------------------------------------------------------------------------

class _Fixture:
    """A KV handle and an ObjectStore on one substrate, and second handles
    that model another process sharing it (the same object in memory, a
    second handle over the same root for the file stores)."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self._extra = []
        if kind == "memory":
            self.kv, self.store = KVStore(num_shards=4), ObjectStore()
        else:
            self.engine = kind.split("-")[1]
            self.kv = FileKVStore(str(tmp_path / "kv"), num_shards=4, fsync="never",
                                  engine=self.engine)
            self.store = ObjectStore(backend=FileBackend(str(tmp_path / "obj"), fsync="never"))

    def second_kv(self):
        if self.kind == "memory":
            return self.kv
        kv = FileKVStore(self.kv.root, num_shards=4, fsync="never", engine=self.engine)
        self._extra.append(kv)
        return kv

    def second_store(self):
        if self.kind == "memory":
            return self.store
        st = ObjectStore(backend=FileBackend(self.store.backend.root, fsync="never"))
        self._extra.append(st.backend)
        return st

    def close(self):
        for h in [*self._extra, self.kv, self.store.backend]:
            close = getattr(h, "close", None)
            if close:
                close()


@pytest.fixture(params=BACKENDS)
def bk(request, tmp_path):
    fx = _Fixture(request.param, tmp_path)
    yield fx
    fx.close()


def _bump(v):
    return (v or 0) + 10


def _capture_then_delete(out, v):
    out["seen"] = v
    return DELETE


def test_kv_roundtrip_and_scan(bk):
    kv = bk.kv
    kv.set("a/1", {"x": 1})
    kv.set("a/2", [1, 2, 3])
    kv.set("b/1", "other")
    assert kv.get("a/1") == {"x": 1}
    assert kv.get("missing") is None and kv.get("missing", default="d") == "d"
    assert sorted(kv.scan("a/")) == ["a/1", "a/2"]
    assert kv.exists("a/2") and not kv.exists("a/3")
    kv.delete("a/2")
    assert not kv.exists("a/2")
    assert kv.cas("a/1", {"x": 1}, "swapped") and not kv.cas("a/1", "stale", "no")
    assert kv.get("a/1") == "swapped"


def test_kv_mget_order_defaults_and_charging(bk):
    kv = bk.kv
    kv.set("a", 1)
    kv.set("b", 2)
    before = kv.total_ops()
    assert kv.mget(["b", "missing", "a"], default="absent") == [2, "absent", 1]
    shards = len({kv.shard_of(k) for k in ["b", "missing", "a"]})
    assert kv.total_ops() - before == shards <= 3  # one charged op per shard touched


def test_kv_mset_batch_charging_and_single_wakeup_per_shard(bk):
    kv = bk.kv
    keys = [f"batch/{i}" for i in range(12)]
    seqs = {k: kv.shard_seq(k) for k in keys}
    before = kv.total_ops()
    kv.mset({k: i for i, k in enumerate(keys)})
    assert kv.total_ops() - before == len({kv.shard_of(k) for k in keys})
    bumps = {}
    for k in keys:
        bumps.setdefault(kv.shard_of(k), set()).add(kv.shard_seq(k) - seqs[k])
    assert all(d == {1} for d in bumps.values()), bumps  # one bump per shard per batch


def test_kv_setnx_incr_and_mdel(bk):
    kv = bk.kv
    assert kv.setnx("claim", "w1") is True
    assert kv.setnx("claim", "w2") is False
    assert kv.get("claim") == "w1"
    assert kv.incr("n", 5) == 5 and kv.incr("n", -2) == 3
    kv.set("d1", 1)
    kv.set("d2", 2)
    assert kv.mdel(["d1", "d2", "nope"]) >= 0
    assert not kv.exists("d1") and not kv.exists("d2")


def test_large_array_parity_and_charging(bk):
    """An 8 MiB array rides every substrate identically: the same values
    back, one charged op per verb, its nbytes charged in full."""
    big = np.arange(1 << 20, dtype=np.float64)
    kv = bk.kv
    ops0 = kv.total_ops()
    bin0 = sum(s.bytes_in for s in kv.shard_stats())
    kv.set("big/a", big)
    np.testing.assert_array_equal(kv.get("big/a"), big)
    assert kv.total_ops() - ops0 == 2
    assert sum(s.bytes_in for s in kv.shard_stats()) - bin0 == big.nbytes
    kv.set("big/b", big * 2)
    kv.set("small", 7)
    got = kv.mget(["big/a", "small", "big/b"])
    np.testing.assert_array_equal(got[2], big * 2)
    assert got[1] == 7
    bk.store.put("blob/x", {"w": big})
    np.testing.assert_array_equal(bk.store.get("blob/x")["w"], big)
    np.testing.assert_array_equal(bk.store.get_many(["blob/x"])["blob/x"]["w"], big)


def test_eval_applies_delete_sentinel_and_side_effects_replay(bk):
    kv = bk.kv
    assert kv.eval("counter", _bump) == 10 and kv.eval("counter", _bump) == 20
    kv.set("rec", {"epoch": 3})
    out = {}
    kv.eval("rec", partial(_capture_then_delete, out))
    assert out["seen"] == {"epoch": 3} and not kv.exists("rec")


def test_eval_many_per_shard_charging_and_delete(bk):
    kv = bk.kv
    keys = [f"em/{i}" for i in range(8)]
    kv.mset({k: 1 for k in keys})
    before = kv.total_ops()
    res = kv.eval_many({k: _bump for k in keys})
    assert kv.total_ops() - before == len({kv.shard_of(k) for k in keys})
    assert all(res[k] == 11 for k in keys)
    outs = {k: {} for k in keys}
    kv.eval_many({k: partial(_capture_then_delete, outs[k]) for k in keys})
    assert all(outs[k]["seen"] == 11 for k in keys)
    assert not any(kv.exists(k) for k in keys)


def test_lists_hand_out_each_element_once(bk):
    kv = bk.kv
    kv.rpush("q", *range(10))
    assert kv.lpop_n("q", 4) == [0, 1, 2, 3]
    assert kv.lpop_n("q", 100) == [4, 5, 6, 7, 8, 9]
    assert kv.lpop_n("q", 1) == [] and kv.llen("q") == 0
    kv.rpush("lst", "a")
    kv.rpush_many({"lst": ["b", "c"], "other": [1]})
    assert kv.lrange("lst") == ["a", "b", "c"] and kv.llen("other") == 1
    assert kv.lpop("lst") == "a"
    kv.rpush_nowait("durs", 0.5)
    kv.rpush_nowait("durs", 0.7)
    deadline = time.monotonic() + 5.0
    while kv.llen("durs") < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert kv.lrange("durs") == [0.5, 0.7]


def test_blpop_cross_handle_wake_is_event_driven(bk):
    consumer, producer = bk.kv, bk.second_kv()
    got = []
    t = threading.Thread(target=lambda: got.append(consumer.blpop("jobs", timeout_s=10.0)))
    t.start()
    time.sleep(0.25)  # let the consumer register its watch and block
    t0 = time.monotonic()
    producer.rpush("jobs", "work")
    t.join(timeout=10.0)
    assert got == ["work"]
    assert time.monotonic() - t0 < 2.0


def test_object_roundtrip_list_and_first_writer_wins(bk):
    st = bk.store
    st.put("res/a", {"v": 1})
    st.put("res/b", [1, 2])
    assert st.get("res/a") == {"v": 1}
    assert st.get_many(["res/a", "res/b", "res/nope"]) == {"res/a": {"v": 1}, "res/b": [1, 2]}
    with pytest.raises(KeyError):
        st.get_many(["res/nope"], missing="error")
    assert st.exists_many(["res/a", "res/zzz"]) == {"res/a"}
    assert st.list("res/") == ["res/a", "res/b"]
    assert st.put("winner", "first", if_absent=True) is True
    assert st.put("winner", "second", if_absent=True) is False
    assert st.put_many({"winner": "third", "fresh": 1}, if_absent=True) == 1
    assert st.get("winner") == "first" and st.get("fresh") == 1
    assert st.delete_prefix("res/") == 2 and st.list("res/") == []


def test_object_wait_keys_cross_handle_zero_fallback_ticks(bk):
    waiter, publisher = bk.store, bk.second_store()
    done = []

    def wait():
        waiter.wait_keys(["out/x", "out/y"], timeout_s=10.0)
        done.append(True)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.25)
    publisher.put("out/x", 1)
    publisher.put("out/y", 2)
    t.join(timeout=10.0)
    assert done == [True] and waiter.fallback_tick_waits == 0


# ---------------------------------------------------------------------------
# the file layout: directory sharding, the watch ledger, fsync policies
# ---------------------------------------------------------------------------

def test_file_backend_layout_ledger_and_rotation(tmp_path, monkeypatch):
    be = FileBackend(str(tmp_path / "obj"), fsync="never")
    st = ObjectStore(backend=be)
    try:
        st.put("result/job/t3", 1)
        assert os.path.exists(tmp_path / "obj" / "result%2Fjob" / "t3")
        ledger = (tmp_path / "obj" / ".watch-seq").read_bytes()
        records = [r for recs, _ in iter_frames(ledger) for r in recs]
        assert records == [("put", "result/job/t3", None)]
        st.delete("result/job/t3")
        assert [r for recs, _ in iter_frames((tmp_path / "obj" / ".watch-seq").read_bytes())
                for r in recs][-1] == ("del", "result/job/t3", None)
        monkeypatch.setattr(FileBackend, "_SEQ_ROTATE_BYTES", 256)
        ino = os.stat(tmp_path / "obj" / ".watch-seq").st_ino
        for i in range(20):
            st.put(f"r/{i}", i)
        assert os.stat(tmp_path / "obj" / ".watch-seq").st_ino != ino  # rotated by rename
        assert os.path.getsize(tmp_path / "obj" / ".watch-seq") < 512
        assert st.list("r/") == sorted(f"r/{i}" for i in range(20))
    finally:
        be.close()


@pytest.mark.parametrize("policy,key,synced", [
    ("auto", "ckpt/run/v1/manifest", True), ("auto", "result/j/t0", False),
    ("always", "result/j/t0", True), ("never", "ckpt/run/v1/manifest", False),
])
def test_file_backend_fsync_policy(tmp_path, monkeypatch, policy, key, synced):
    """``auto`` fsyncs each put under ``ckpt/`` (checkpoints survive a
    machine crash) and group-commits the rest."""
    calls = []
    monkeypatch.setattr(tos.os, "fsync", lambda fd: calls.append(fd))
    be = FileBackend(str(tmp_path / "obj"), fsync=policy)
    try:
        ObjectStore(backend=be).put_bytes(key, b"x" * 10)
        assert bool(calls) == synced
    finally:
        be.close()
    with pytest.raises(ValueError):
        FileBackend(str(tmp_path / "o2"), fsync="sometimes")


def test_batched_puts_and_gets_ride_the_io_pool(tmp_path):
    be = FileBackend(str(tmp_path / "obj"), fsync="never")
    st = ObjectStore(backend=be)
    try:
        items = {f"b/{i}": bytes([i]) * 100 for i in range(20)}
        assert st.put_many_bytes(items) == 20 and be._io_pool is not None
        assert st.get_many_bytes(list(items)) == items
        assert st.exists_many(list(items) + ["b/none"]) == set(items)
        # the whole batch is one ledger frame
        frames = list(iter_frames((tmp_path / "obj" / ".watch-seq").read_bytes()))
        assert len(frames) == 1 and len(frames[0][0]) == 20
    finally:
        be.close()


# ---------------------------------------------------------------------------
# frames and logs
# ---------------------------------------------------------------------------

def test_frame_and_log_header_layout():
    frame = encode_frame([("s", "k", 1), ("a", "q", [2])])
    length, crc = struct.unpack_from("<II", frame)
    assert length == len(frame) - 8 and crc == zlib.crc32(frame[8:])
    assert [recs for recs, _ in iter_frames(frame + frame[:-2])] == [[("s", "k", 1), ("a", "q", [2])]]
    head = encode_log_header(7)
    assert head[:4] == LOG_MAGIC and decode_log_header(head) == 7
    assert decode_log_header(head[:5]) is None and decode_log_header(b"XXXX" + head[4:]) is None
    assert BUF_FLAG == 1 << 31 and MAX_FRAME_LEN == 1 << 30 and MAX_FRAME_LEN < BUF_FLAG


def _shard_log(root):
    (path,) = glob.glob(os.path.join(root, "shard-0.log"))
    return path


def test_torn_garbage_tail_dropped_and_truncated(tmp_path):
    root = str(tmp_path / "kv")
    kv = FileKVStore(root, num_shards=1)
    kv.set("k", "keep", worker="t")
    kv.rpush("q", 1, 2, worker="t")
    kv.close()
    with open(_shard_log(root), "ab") as f:
        f.write(b"\xde\xad\xbe\xef torn garbage")
    size_torn = os.path.getsize(_shard_log(root))
    kv2 = FileKVStore(root, num_shards=1)
    try:
        assert kv2.get("k") == "keep" and kv2.lrange("q") == [1, 2]
        kv2.set("after", 1, worker="t")  # the next commit truncates the garbage
        assert os.path.getsize(_shard_log(root)) < size_torn + 64
    finally:
        kv2.close()
    kv3 = FileKVStore(root, num_shards=1)
    try:
        assert kv3.get("after") == 1 and kv3.get("k") == "keep"
    finally:
        kv3.close()


def test_torn_half_frame_and_bad_crc_dropped(tmp_path):
    root = str(tmp_path / "kv")
    kv = FileKVStore(root, num_shards=1)
    kv.set("k", 42, worker="t")
    kv.close()
    frame = encode_frame([("s", "lost", "never committed")])
    for torn in (frame[:-3], frame[:-1] + bytes([frame[-1] ^ 0xFF])):
        with open(_shard_log(root), "ab") as f:
            f.write(torn)
        kv2 = FileKVStore(root, num_shards=1)
        try:
            assert kv2.get("k") == 42 and kv2.get("lost") is None
        finally:
            kv2.close()


def test_truncated_log_header_recovers_from_snapshot(tmp_path):
    root = str(tmp_path / "kv")
    kv = FileKVStore(root, num_shards=1, compact_min_bytes=64)
    for i in range(20):
        kv.set(f"k{i}", i, worker="t")
    kv.close()
    assert glob.glob(os.path.join(root, "shard-0.snap.*"))
    with open(_shard_log(root), "wb") as f:
        f.write(b"\x00\x01")
    kv2 = FileKVStore(root, num_shards=1)
    try:
        assert kv2.get("k0") == 0
        kv2.set("post", 1, worker="t")
        assert kv2.get("post") == 1
    finally:
        kv2.close()


def test_snapshot_published_but_log_not_swapped_reads_back_identically(tmp_path):
    """The compaction crash window: the G+1 snapshot landed, the log still
    at G with all its records; a warm peer keeps appending to the old log.
    The state reads back once (never doubled) with the peer's commit."""
    root = str(tmp_path / "kv")
    kv = FileKVStore(root, num_shards=1)
    peer = FileKVStore(root, num_shards=1)
    for i in range(10):
        kv.rpush("q", i, worker="t")
    kv.incr("ctr", 5, worker="t")
    assert peer.llen("q") == 10
    engine = kv._engines[0]
    engine._publish_snapshot(dict(engine.load()))
    kv.close()
    peer.rpush("q", 10, worker="peer")
    peer.close()
    fresh = FileKVStore(root, num_shards=1)
    try:
        assert fresh.lrange("q") == list(range(11)) and fresh.get("ctr") == 5
        fresh.rpush("q", 11, worker="t")
    finally:
        fresh.close()
    again = FileKVStore(root, num_shards=1)
    try:
        assert again.lrange("q") == list(range(12))
    finally:
        again.close()


def test_compaction_bounds_log_runs_off_thread_and_preserves_state(tmp_path):
    root = str(tmp_path / "kv")
    kv = FileKVStore(root, num_shards=1, compact_min_bytes=2048)
    eng = kv._engines[0]
    threads = []
    orig = eng.finish_compaction
    eng.finish_compaction = lambda plan: (threads.append(threading.current_thread().name),
                                          orig(plan))[1]
    try:
        for i in range(300):
            kv.set(f"k{i % 7}", "v" * 200, worker="t")
        kv.compact_now()
        assert threads and set(threads) == {"filekv-compactor"}
        assert os.path.getsize(_shard_log(root)) < 20_000
    finally:
        kv.close()
    fresh = FileKVStore(root, num_shards=1)
    try:
        assert all(fresh.get(f"k{i}") == "v" * 200 for i in range(7))
    finally:
        fresh.close()


def test_log_and_snapshot_engines_agree_and_price_their_bytes(tmp_path):
    stores = {
        "log": FileKVStore(str(tmp_path / "log"), num_shards=2, engine="log",
                           compact_min_bytes=512),
        "snapshot": FileKVStore(str(tmp_path / "snap"), num_shards=2, engine="snapshot"),
    }
    resident = {f"key{i}": f"v{i:04d}" * 20 for i in range(300)}
    per_op = {}
    for name, kv in stores.items():
        kv.mset({"a": 1, "b": [1, 2], "c": "x"}, worker="t")
        kv.rpush("q", 1, 2, 3, worker="t")
        assert kv.lpop("q") == 1
        kv.incr("ctr", 2.5, worker="t")
        kv.eval("b", _append_three, worker="t")
        kv.eval("c", _delete, worker="t")
        kv.delete("a", worker="t")
        kv.setnx("nx", 9, worker="t")
        assert kv.lpop_n("q", 5) == [2, 3]
        kv.mset(resident, worker="t")
        kv.compact_now()  # the compaction this mset flagged lands before the window
        mark = kv.disk_bytes_written()
        for i in range(20):
            kv.set("hot", i, worker="t")
        per_op[name] = (kv.disk_bytes_written() - mark) / 20
    views = {}
    for name, kv in stores.items():
        reopened = FileKVStore(kv.root, num_shards=2, engine=kv.engine)
        views[name] = {k: reopened.get(k) for k in ["a", "b", "c", "ctr", "nx", "q", "hot"]}
        reopened.close()
        kv.close()
    assert views["log"] == views["snapshot"]
    assert views["log"]["b"] == [1, 2, 3] and views["log"]["a"] is None
    assert per_op["log"] < 100 < 10_000 < per_op["snapshot"]  # O(record) vs O(shard)


def _append_three(v):
    return v + [3]


def _delete(v):
    return DELETE


def test_stored_none_is_a_real_queue_element(tmp_path):
    kv = FileKVStore(str(tmp_path / "kv"), num_shards=1)
    try:
        kv.rpush("q", None, 7, worker="t")
        assert kv.blpop("q", timeout_s=5.0) is None
        assert kv.lpop("q") == 7 and kv.llen("q") == 0
    finally:
        kv.close()


# ---------------------------------------------------------------------------
# SIGKILLed writers (subprocesses)
# ---------------------------------------------------------------------------

def _writer_main(root, compact_min_bytes):
    """Append ``i`` to ``log`` and mirror it into ``a`` and ``b`` (one
    frame) until killed."""
    kv = FileKVStore(root, num_shards=1, fsync="never", compact_min_bytes=compact_min_bytes)
    i = kv.llen("log", worker="w")
    while True:
        kv.rpush("log", i, worker="w")
        kv.mset({"a": i, "b": i}, worker="w")
        i += 1


def _kill_cycle(root, compact_min_bytes, min_entries):
    proc = _spawn("writer", root, str(compact_min_bytes))
    watcher = FileKVStore(root, num_shards=1)
    try:
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT_S
        baseline = watcher.llen("log")
        while watcher.llen("log") < baseline + min_entries:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "the writer made no progress"
            time.sleep(0.01)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=15)
        watcher.close()
    fresh = FileKVStore(root, num_shards=1)
    try:
        entries = fresh.lrange("log")
        a, b = fresh.mget(["a", "b"])
        assert a == b, f"half-applied transaction after the kill: a={a} b={b}"
        assert not entries or a in (None, entries[-1], entries[-1] - 1)
        return entries
    finally:
        fresh.close()


@pytest.mark.parametrize("compact_min_bytes,cycles", [(1 << 30, 1), (2048, 2)],
                         ids=["steady", "compaction-storm"])
def test_sigkilled_writer_leaves_its_committed_prefix(tmp_path, compact_min_bytes, cycles):
    root = str(tmp_path / "kv")
    for _ in range(cycles):
        entries = _kill_cycle(root, compact_min_bytes, min_entries=30)
        assert entries == list(range(len(entries))), (len(entries), entries[-5:])
    if compact_min_bytes < 1 << 20:
        assert glob.glob(os.path.join(root, "shard-0.snap.*"))  # compaction ran


def test_inotify_wake_has_zero_poll_wakeups(tmp_path):
    from repro_torch.storage.inotify import Inotify

    if not Inotify.available():
        pytest.skip("inotify is not available on this platform")
    consumer = FileKVStore(str(tmp_path / "kv"), num_shards=1)
    producer = FileKVStore(str(tmp_path / "kv"), num_shards=1)
    try:
        got = []
        th = threading.Thread(target=lambda: got.append(consumer.blpop("q", timeout_s=20.0)))
        th.start()
        time.sleep(0.3)
        producer.rpush("q", "wake", worker="t")
        th.join(timeout=20)
        assert got == ["wake"]
        assert consumer._watcher.mode == "inotify" and consumer._watcher.poll_wakeups == 0
    finally:
        consumer.close()
        producer.close()


def test_poll_fallback_still_wakes_when_inotify_is_off(tmp_path):
    consumer = FileKVStore(str(tmp_path / "kv"), num_shards=1)
    producer = FileKVStore(str(tmp_path / "kv"), num_shards=1)

    def on_change(changed):
        for sidx in changed:
            sh = consumer._shards[sidx]
            with sh.lock:
                sh.touch()

    consumer._watcher = tos._PollWatcher([e.watch_path for e in consumer._engines], on_change,
                                         use_inotify=False)
    try:
        got = []
        th = threading.Thread(target=lambda: got.append(consumer.blpop("q", timeout_s=20.0)))
        th.start()
        time.sleep(0.2)
        producer.rpush("q", "wake", worker="t")
        th.join(timeout=20)
        assert got == ["wake"]
        assert consumer._watcher.mode == "poll" and consumer._watcher.poll_wakeups > 0
    finally:
        consumer.close()
        producer.close()


# ---------------------------------------------------------------------------
# handles across processes
# ---------------------------------------------------------------------------

def test_file_handles_reopen_in_another_process_from_their_spec(tmp_path):
    kv = FileKVStore(str(tmp_path / "kv"), num_shards=2)
    store = ObjectStore(backend=FileBackend(str(tmp_path / "obj")))
    try:
        blob = pickle.dumps((kv, store))
        assert pickle.loads(blob)[0] is kv  # the same process: the same handle
        out = _wait(_spawn("reopen", blob.hex()), "the reopening process")
        assert "reopened" in out
        assert kv.get("from/child") == os.path.basename(str(tmp_path))
        assert store.get("from/child") == [1, 2]
    finally:
        kv.close()
        store.backend.close()


def _reopen_main(blob_hex):
    kv, store = pickle.loads(bytes.fromhex(blob_hex))
    assert isinstance(kv, FileKVStore) and isinstance(store.backend, FileBackend)
    kv.set("from/child", os.path.basename(os.path.dirname(kv.root)))
    store.put("from/child", [1, 2])
    print("reopened", flush=True)


def test_unreachable_handles_say_why():
    uid = "ObjectStore-gone"
    with pytest.raises(RuntimeError, match="carries no reconnect spec"):
        tos._resolve_handle(uid)
    with pytest.raises(RuntimeError, match="'kind': 'object'.*failed"):
        tos._resolve_handle(uid, {"kind": "object", "root": "/dev/null/x"})
    for kind in ("net_kv", "net_obj"):  # the wire tier: no daemon at the address
        with pytest.raises(RuntimeError, match=f"'kind': '{kind}'.*failed: repro-kvd at "
                                               "unix:/nowhere.* unreachable"):
            tos._resolve_handle(uid, {"kind": kind, "addr": "unix:/nowhere"})
    mem = pickle.dumps(ObjectStore())
    code = f"import pickle; pickle.loads(bytes.fromhex({mem.hex()!r}))"
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode != 0 and "in-memory handles cannot cross processes" in proc.stderr


# ---------------------------------------------------------------------------
# the runtime across processes
# ---------------------------------------------------------------------------

def triple(x):
    return x * 3


def test_cross_process_map_is_event_driven(tmp_path):
    """A worker pool in a subprocess over the shared file stores executes
    every task of a map submitted here: queue pushes wake its blpop, result
    publishes wake this driver's futures, with no fallback tick."""
    from repro_torch.core import SchedulerConfig, WrenExecutor, get_all

    kv = FileKVStore(str(tmp_path / "kv"), num_shards=2)
    store = ObjectStore(backend=FileBackend(str(tmp_path / "obj")))
    wex = WrenExecutor(store=store, kv=kv, num_workers=0,  # every task runs in the child
                       scheduler_config=SchedulerConfig(lease_timeout_s=10.0))
    proc = _spawn("pool", kv.root, store.backend.root)
    try:
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT_S
        while kv.get("ctl/ready") is None:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "the subprocess pool never came up"
            time.sleep(0.05)
        t0 = time.monotonic()
        futs = wex.map(triple, list(range(16)), job_id="xproc")
        assert get_all(futs, timeout_s=60) == [x * 3 for x in range(16)]
        assert len(store.list("result/xproc/")) == 16
        assert store.fallback_tick_waits == 0
        assert time.monotonic() - t0 < 15.0
    finally:
        kv.rpush("ctl/shutdown", 1, worker="driver")
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
        wex.shutdown()
        kv.close()
        store.backend.close()
    assert proc.returncode == 0, proc.stdout.read().decode()


def _pool_main(kv_root, obj_root):
    from repro_torch.core import Scheduler, SchedulerConfig, WorkerPool

    kv = FileKVStore(kv_root, num_shards=2)
    store = ObjectStore(backend=FileBackend(obj_root))
    pool = WorkerPool(store, Scheduler(kv, store, SchedulerConfig(lease_timeout_s=10.0)),
                      num_workers=2)
    kv.set("ctl/ready", 1, worker="child")
    while kv.blpop("ctl/shutdown", timeout_s=5.0) is None:
        pass
    pool.stop_all()


# ---------------------------------------------------------------------------
# the elastic trainer resumed from a file root in a fresh process
# ---------------------------------------------------------------------------

def _elastic(root, total_steps):
    """Train the reduced llama3-8b on the CPU through the port's runtime
    over ``ObjectStore(backend=FileBackend(root, fsync="never"))`` to
    ``total_steps`` (2 per chunk, int8 moments); -> the chunks' losses.
    (The durability policy is not under test; ``auto``'s group commit is an
    ``os.sync()`` of the whole machine.)"""
    from repro_torch.configs import CONFIGS
    from repro_torch.core import WrenExecutor
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.train import elastic, optimizer

    torch.set_num_threads(1)
    cfg = CONFIGS["llama3-8b"].reduced()
    dcfg = DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)
    opt = optimizer.adamw(optimizer.cosine_schedule(3e-3, warmup=1, total=8),
                          quantize_moments=True)
    wex = WrenExecutor(store=ObjectStore(backend=FileBackend(root, fsync="never")),
                       num_workers=1)
    try:
        tcfg = elastic.ElasticTrainConfig(run="resume", steps_per_chunk=2,
                                          total_steps=total_steps)
        hist = elastic.train_elastic(wex, cfg, opt, tcfg, partial(synthetic_batch, dcfg, cfg=cfg),
                                     device="cpu")
    finally:
        wex.shutdown()
        wex.store.backend.close()
        elastic.WARM_CACHE.clear()
    return [h["loss"] for h in hist]


def test_checkpoint_round_trips_through_a_file_backend(tmp_path):
    """bf16, fp32, int8 and 0-d leaves, over several 64 MB chunks' worth of
    views written straight from the host arrays; back bit for bit."""
    from repro_torch.train import checkpoint as ck

    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "m": {"q": torch.randint(-127, 128, (4, 256), dtype=torch.int8, generator=g),
                   "scale": torch.rand(4, 1, generator=g)},
             "step": torch.tensor(7, dtype=torch.int32),
             "big": torch.arange(3 * 2**20, dtype=torch.float32)}
    orig = {k: v.clone() for k, v in tree_items(state)}
    chunk = ck.CHUNK_BYTES
    ck.CHUNK_BYTES = 2**20  # several chunks per large leaf
    try:
        be = FileBackend(str(tmp_path), fsync="never")
        assert ck.save(ObjectStore(backend=be), "f", 3, state)
        assert len([k for k in be.list("ckpt/f/v00000003/leaf/") if "/00000/" in k]) == 12
    finally:
        ck.CHUNK_BYTES = chunk
    loaded, _, v = ck.load(ObjectStore(backend=FileBackend(str(tmp_path))), "f")
    assert v == 3
    for (k, a), (_, b) in zip(tree_items(state), tree_items(loaded)):
        assert a.dtype == b.dtype and torch.equal(a.reshape(b.shape), b), k
        assert torch.equal(orig[k], a)  # the views left the state as it was


def tree_items(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_items(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_elastic_resumes_in_a_fresh_process_with_bit_equal_losses(tmp_path):
    whole = _elastic(str(tmp_path / "whole"), 8)
    first = _elastic(str(tmp_path / "split"), 4)
    out = _wait(_spawn("elastic", str(tmp_path / "split"), "8"), "the resuming process")
    rest = [float(x) for x in out.strip().splitlines()[-1].split()]
    assert len(whole) == 4 and len(first) == 2 and len(rest) == 2
    assert first + rest == whole  # bit for bit


if __name__ == "__main__":
    role = sys.argv[1]
    if role == "writer":
        _writer_main(sys.argv[2], int(sys.argv[3]))
    elif role == "reopen":
        _reopen_main(sys.argv[2])
    elif role == "pool":
        _pool_main(sys.argv[2], sys.argv[3])
    elif role == "elastic":
        print(" ".join(repr(x) for x in _elastic(sys.argv[2], int(sys.argv[3]))))
    else:
        raise SystemExit(f"unknown role {role!r}")
