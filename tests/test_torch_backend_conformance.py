"""Cross-backend conformance of the port's stores
(`tests/test_backend_conformance.py`'s twin): one behavioural contract,
three substrates.

Every test here runs against the port's in-memory stores, its file
substrate (``FileKVStore``/``FileBackend``) and its wire tier (the port's
``repro-kvd`` daemon + ``NetKVStore``/``NetBackend``), so the scheduler and
executor run unchanged over any of them.  The eval helpers are module-level
functions (the port sends evals with the standard pickle):

  * batched verbs (``mget``/``mset``/``eval_many``/``rpush_many``) keep the
    in-memory charging model: one charged op per shard touched, never one per
    key — and on the wire tier one *frame* per batched verb;
  * a batch bumps each touched shard's sequence exactly ONCE (a widening
    batch cannot multiply watcher wakeups);
  * ``eval`` runs server-side but its captured-state side effects land on
    the caller via the replay contract, and the ``DELETE`` sentinel drops
    the key from any backend;
  * first-writer-wins everywhere it is promised: ``setnx`` on the KV,
    ``if_absent`` puts on the object tier;
  * destructive reads (``lpop_n``/``blpop``) hand each element to exactly
    one consumer, across handles and across the wire;
  * waits are event-driven: a cross-handle publisher wakes a blocked
    ``wait_keys``/``blpop`` with zero fallback poll ticks.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.storage import (  # noqa: E402
    DELETE,
    FileBackend,
    FileKVStore,
    KVStore,
    NetBackend,
    NetKVStore,
    ObjectStore,
    kv_pure,
)
from repro_torch.storage.net_server import KVDServer  # noqa: E402

BACKENDS = ("memory", "file", "net")


class _Fixture:
    """One backend instantiation: a KV handle, an ObjectStore, and
    second-handle factories that model a *different process* sharing the
    substrate (a second client for net, a second root-handle for file)."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self._extra = []
        if kind == "memory":
            self.kv = KVStore(num_shards=4)
            self.store = ObjectStore()
            self.server = None
        elif kind == "file":
            self.kv = FileKVStore(str(tmp_path / "kv"), num_shards=4, fsync="never")
            self.store = ObjectStore(
                backend=FileBackend(str(tmp_path / "obj"), fsync="never")
            )
            self.server = None
        else:
            self.server = KVDServer(
                str(tmp_path / "kvd"),
                f"unix:{tmp_path / 'kvd.sock'}",
                num_shards=4,
                fsync="never",
            ).start()
            self.kv = NetKVStore(self.server.address)
            self.store = ObjectStore(backend=NetBackend(self.server.address))

    def seq_probe(self, key):
        """The authoritative wake-token sequence for ``key``'s shard.  For
        the wire tier that lives on the SERVER (clients mirror it only via
        pushes while watching), so probe the server's store directly."""
        if self.kind == "net":
            return self.server.kv.shard_seq(key)
        return self.kv.shard_seq(key)

    def second_kv(self):
        """A handle another process would hold."""
        if self.kind == "memory":
            return self.kv  # in-memory state IS the shared substrate
        if self.kind == "file":
            kv = FileKVStore(self.kv.root, num_shards=4, fsync="never")
        else:
            kv = NetKVStore(self.server.address)
        self._extra.append(kv)
        return kv

    def second_store(self):
        if self.kind == "memory":
            return self.store
        if self.kind == "file":
            st = ObjectStore(backend=FileBackend(self.store.backend.root, fsync="never"))
        else:
            st = ObjectStore(backend=NetBackend(self.server.address))
        self._extra.append(st)
        return st

    def close(self):
        for h in self._extra:
            close = getattr(h, "close", None) or getattr(h.backend, "close", None)
            close()
        for h in (self.kv, self.store.backend, self.server):
            close = getattr(h, "close", None)
            if close:
                close()


@pytest.fixture(params=BACKENDS)
def bk(request, tmp_path):
    fx = _Fixture(request.param, tmp_path)
    yield fx
    fx.close()


# ---------------------------------------------------------------------------
# KV plane: roundtrips, batching, charging
# ---------------------------------------------------------------------------

def test_kv_roundtrip_and_scan(bk):
    kv = bk.kv
    kv.set("a/1", {"x": 1})
    kv.set("a/2", [1, 2, 3])
    kv.set("b/1", "other")
    assert kv.get("a/1") == {"x": 1}
    assert kv.get("missing") is None
    assert kv.get("missing", default="d") == "d"
    assert sorted(kv.scan("a/")) == ["a/1", "a/2"]
    assert kv.exists("a/2") and not kv.exists("a/3")
    kv.delete("a/2")
    assert not kv.exists("a/2")


def test_kv_mget_order_defaults_and_charging(bk):
    kv = bk.kv
    kv.set("a", 1)
    kv.set("b", 2)
    before = kv.total_ops()
    out = kv.mget(["b", "missing", "a"], default="absent")
    assert out == [2, "absent", 1]
    # THE batched-op charging formula, identical across substrates: one
    # charged op per shard touched, never one per key.
    shards = len({kv.shard_of(k) for k in ["b", "missing", "a"]})
    assert kv.total_ops() - before == shards <= 3


def test_kv_mset_batch_charging_and_single_wakeup_per_shard(bk):
    kv = bk.kv
    keys = [f"batch/{i}" for i in range(12)]
    seqs = {k: bk.seq_probe(k) for k in keys}
    before = kv.total_ops()
    kv.mset({k: i for i, k in enumerate(keys)})
    shards = {kv.shard_of(k) for k in keys}
    assert kv.total_ops() - before == len(shards)
    # each touched shard's sequence advanced exactly once for the batch —
    # a widening batch cannot multiply watcher wakeups
    bumps = {}
    for k in keys:
        bumps.setdefault(kv.shard_of(k), set()).add(bk.seq_probe(k) - seqs[k])
    for sidx, deltas in bumps.items():
        assert deltas == {1}, f"shard {sidx} bumped {deltas} times"


def test_kv_setnx_first_writer_wins(bk):
    kv = bk.kv
    assert kv.setnx("claim", "w1") is True
    assert kv.setnx("claim", "w2") is False
    assert kv.get("claim") == "w1"


def test_kv_incr_and_mdel(bk):
    kv = bk.kv
    assert kv.incr("n", 5) == 5
    assert kv.incr("n", -2) == 3
    kv.set("d1", 1)
    kv.set("d2", 2)
    assert kv.mdel(["d1", "d2", "nope"]) >= 0
    assert not kv.exists("d1") and not kv.exists("d2")


def test_large_array_parity_and_charging(bk):
    """A ≥ 8 MiB ndarray rides every substrate identically — same
    values back through set/get/mget and object put/get/get_many, and the
    same charging rows (one op per verb per shard touched, the payload's
    nbytes charged in full) whether the bytes moved through process memory,
    the shard log, or wire buffer frames."""
    big = np.arange(1 << 20, dtype=np.float64)  # 8 MiB
    kv = bk.kv
    ops0 = kv.total_ops()
    bin0 = sum(s.bytes_in for s in kv.shard_stats())
    bout0 = sum(s.bytes_out for s in kv.shard_stats())
    kv.set("big/a", big)
    np.testing.assert_array_equal(kv.get("big/a"), big)
    assert kv.total_ops() - ops0 == 2  # one charged op per verb
    assert sum(s.bytes_in for s in kv.shard_stats()) - bin0 == big.nbytes
    assert sum(s.bytes_out for s in kv.shard_stats()) - bout0 == big.nbytes
    kv.set("big/b", big * 2)
    kv.set("small", 7)
    ops1 = kv.total_ops()
    got = kv.mget(["big/a", "small", "big/b"])
    np.testing.assert_array_equal(got[0], big)
    assert got[1] == 7
    np.testing.assert_array_equal(got[2], big * 2)
    # batched charging stays per-shard even when the rows are 8 MiB wide
    shards = len({kv.shard_of(k) for k in ["big/a", "small", "big/b"]})
    assert kv.total_ops() - ops1 == shards
    st = bk.store
    st.put("blob/x", {"w": big})
    np.testing.assert_array_equal(st.get("blob/x")["w"], big)
    np.testing.assert_array_equal(st.get_many(["blob/x"])["blob/x"]["w"], big)


def test_net_large_payload_rides_buffer_frames_not_pickle(bk):
    """The zero-copy acceptance pin (wire tier only): moving an 8 MiB blob
    through the object plane must move ≥ 5× fewer bytes through the pickle
    codec than the payload itself — the raw bytes ride out-of-band buffer
    frames.  A pickled-path control client on the same daemon moves the
    payload through the codec in full."""
    if bk.kind != "net":
        pytest.skip("wire-tier byte accounting only exists on the net backend")
    blob = np.arange(1 << 20, dtype=np.float64).tobytes()  # 8 MiB
    st = bk.store
    client = st.backend._client
    p0, b0 = client.bytes_pickled, client.bytes_buffer
    st.put_bytes("zc/x", blob)
    assert st.get_bytes("zc/x") == blob
    pickled = client.bytes_pickled - p0
    buffered = client.bytes_buffer - b0
    assert buffered >= 2 * len(blob)  # put out + get back, both out-of-band
    assert pickled * 5 < 2 * len(blob)  # ≥5× fewer copied bytes than payload
    # control: a zero_copy=False client pays the codec in full
    legacy = ObjectStore(backend=NetBackend(bk.server.address, zero_copy=False))
    try:
        lc = legacy.backend._client
        lp0 = lc.bytes_pickled
        legacy.put_bytes("zc/legacy", blob)
        assert legacy.get_bytes("zc/legacy") == blob
        assert lc.bytes_pickled - lp0 >= 2 * len(blob)
        assert lc.bytes_buffer == 0
    finally:
        legacy.backend.close()


# ---------------------------------------------------------------------------
# eval: server-side scripting, replay side effects, DELETE sentinel
# ---------------------------------------------------------------------------

@kv_pure
def _bump(cur):
    return int(cur or 0) + 10


@kv_pure
def _capture_then_delete(out, cur):
    out["seen"] = cur
    return DELETE


def test_eval_applies_and_returns_new_value(bk):
    assert bk.kv.eval("counter", _bump) == 10
    assert bk.kv.eval("counter", _bump) == 20
    assert bk.kv.get("counter") == 20


def test_eval_delete_sentinel_drops_key_and_side_effects_replay(bk):
    """The eval replay contract: the function runs inside the store's shard
    transaction, but mutations to captured state (the ``out`` dict riding a
    partial) land on the CALLER — identically in-process and over the
    wire."""
    from functools import partial

    kv = bk.kv
    kv.set("rec", {"epoch": 3})
    out = {}
    kv.eval("rec", partial(_capture_then_delete, out))
    assert out["seen"] == {"epoch": 3}
    assert not kv.exists("rec")


def test_eval_many_per_shard_charging_and_delete(bk):
    from functools import partial

    kv = bk.kv
    keys = [f"em/{i}" for i in range(8)]
    for k in keys:
        kv.set(k, 1)
    before = kv.total_ops()
    res = kv.eval_many({k: _bump for k in keys})
    assert kv.total_ops() - before == len({kv.shard_of(k) for k in keys})
    assert all(res[k] == 11 for k in keys)
    outs = {k: {} for k in keys}
    kv.eval_many({k: partial(_capture_then_delete, outs[k]) for k in keys})
    assert all(outs[k]["seen"] == 11 for k in keys)
    assert not any(kv.exists(k) for k in keys)


# ---------------------------------------------------------------------------
# lists: exactly-once destructive reads, cross-handle wakes
# ---------------------------------------------------------------------------

def test_lpop_n_hands_out_each_element_once(bk):
    kv = bk.kv
    kv.rpush("q", *range(10))
    a = kv.lpop_n("q", 4)
    b = kv.lpop_n("q", 100)
    assert a == [0, 1, 2, 3]
    assert b == [4, 5, 6, 7, 8, 9]
    assert kv.lpop_n("q", 1) == []
    assert kv.llen("q") == 0


def test_rpush_lrange_llen(bk):
    kv = bk.kv
    kv.rpush("lst", "a")
    kv.rpush("lst", "b", "c")
    assert kv.llen("lst") == 3
    assert kv.lrange("lst") == ["a", "b", "c"]


def test_rpush_nowait_lands(bk):
    kv = bk.kv
    kv.rpush_nowait("durs", 0.5)
    kv.rpush_nowait("durs", 0.7)
    # advisory, but ordered behind this handle's own next call
    deadline = time.monotonic() + 5.0
    while kv.llen("durs") < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert kv.lrange("durs") == [0.5, 0.7]


def test_blpop_cross_handle_wake_is_event_driven(bk):
    """A consumer blocked in one handle is woken by a producer in ANOTHER
    handle (another process for file, another socket for net) — promptly,
    with no fallback polling."""
    consumer_kv = bk.kv
    producer_kv = bk.second_kv()
    got = []

    def consume():
        got.append(consumer_kv.blpop("jobs", timeout_s=10.0))

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.25)  # let the consumer register its watch and block
    t0 = time.monotonic()
    producer_kv.rpush("jobs", "work")
    t.join(timeout=10.0)
    assert got == ["work"]
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# object plane
# ---------------------------------------------------------------------------

def test_object_roundtrip_list_and_missing(bk):
    st = bk.store
    st.put("res/a", {"v": 1})
    st.put("res/b", [1, 2])
    assert st.get("res/a") == {"v": 1}
    got = st.get_many(["res/a", "res/b", "res/nope"])
    assert got == {"res/a": {"v": 1}, "res/b": [1, 2]}
    with pytest.raises(KeyError):
        st.get_many(["res/nope"], missing="error")
    assert st.exists("res/a") and not st.exists("res/zzz")
    assert st.exists_many(["res/a", "res/zzz"]) == {"res/a"}


def test_object_if_absent_first_writer_wins(bk):
    st = bk.store
    assert st.put("winner", "first", if_absent=True) is True
    assert st.put("winner", "second", if_absent=True) is False
    assert st.get("winner") == "first"
    n = st.put_many({"winner": "third", "fresh": 1}, if_absent=True)
    assert n == 1
    assert st.get("winner") == "first"
    assert st.get("fresh") == 1


def test_object_wait_keys_cross_handle_zero_fallback_ticks(bk):
    """``wait_keys`` blocked in one handle returns when ANOTHER handle
    publishes — via the backend's own watch/push plane, with zero fallback
    poll ticks (the no-polling contract)."""
    waiter = bk.store
    publisher = bk.second_store()
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
    assert done == [True]
    assert waiter.fallback_tick_waits == 0


# ---------------------------------------------------------------------------
# the port's runtime over its own daemon: every eval it sends pickles by
# reference (a closure left anywhere would raise TypeError here)
# ---------------------------------------------------------------------------

def _lsq_grad(w, shard):
    X, y = shard
    return 2.0 * X.T @ (X @ w - y) / len(y)


def _triple(x):
    return 3 * x


def test_the_ports_runtime_runs_over_its_daemon(tmp_path):
    """``WrenExecutor`` with its store and KV on one port daemon: a map, a
    word count (job manifests, the shuffle), a terasort with its
    intermediates on the KV, and HOGWILD! pushes (``eval_many`` of the
    parameter server's update functions), each equal to its in-process
    result."""
    from collections import Counter

    from repro_torch.core import ParameterServer, PSConfig, WrenExecutor, get_all
    from repro_torch.core import hogwild_sgd, terasort, verify_sorted, word_count
    from repro_torch.data import make_documents
    from repro_torch.storage import shuffle as shf

    server = KVDServer(str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}",
                       num_shards=4, fsync="never").start()
    kv = NetKVStore(server.address)
    store = ObjectStore(backend=NetBackend(server.address))
    try:
        with WrenExecutor(store=store, kv=kv, num_workers=4) as wex:
            assert get_all(wex.map(_triple, list(range(20))), timeout_s=60) == [
                3 * x for x in range(20)]
            docs = make_documents(8, 5, seed=1)
            assert word_count(wex, docs, num_reducers=3) == dict(
                Counter(w for d in docs for line in d for w in line.split()))
            keys = []
            for i in range(4):
                store.put(f"sin/{i}", shf.make_sort_records(50, seed=i))
                keys.append(f"sin/{i}")
            rep = terasort(wex, keys, "sout", 4, intermediate=kv)
            assert verify_sorted(store, "sout") and rep.n_records == 200
            assert rep.n_intermediate_objects == 16 and kv.scan("shuffle/") == []
            rng = np.random.default_rng(0)
            X = rng.normal(size=(32, 8))
            shards = [(X, X @ rng.normal(size=8))]
            out = []
            for ps_kv in (KVStore(num_shards=4), kv):
                ps = ParameterServer(ps_kv, np.zeros(8), PSConfig(num_blocks=3, compress_int8=True))
                out.append(hogwild_sgd(wex, ps, _lsq_grad, shards, steps_per_worker=5, lr=0.01))
            assert np.array_equal(out[0], out[1])  # one worker: the same steps, bit for bit
        assert kv._client.reconnects == 0
    finally:
        kv.close()
        store.backend.close()
        server.close()


def _read_through_specs(blob):
    """In a fresh process: unpickle handles whose owner is gone, so each
    resolves through its reconnect spec."""
    import pickle

    kv, store = pickle.loads(blob)
    print(type(kv).__name__, type(store.backend).__name__, kv.get("k"), store.get("o"),
          flush=True)


def test_reconnect_builds_net_handles_from_their_specs(tmp_path):
    """A net handle pickles as its ``net_kv`` / ``net_obj`` spec; another
    process rebuilds ``NetKVStore`` and ``ObjectStore(NetBackend)`` from it
    (``object_store._reconnect``) and reads what this process wrote."""
    import os
    import pickle
    import subprocess
    import sys

    server = KVDServer(str(tmp_path / "kvd"), "127.0.0.1", 0, num_shards=2,
                       fsync="never").start()
    kv = NetKVStore(server.address)
    store = ObjectStore(backend=NetBackend(server.address))
    try:
        assert kv._endpoint_spec() == {"kind": "net_kv", "addr": server.address}
        assert store.backend.endpoint_spec() == {"kind": "net_obj", "addr": server.address}
        kv.set("k", [1, "two"])
        store.put("o", {"v": 3})
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(os.path.dirname(here), "src")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, here, os.environ.get("PYTHONPATH", "")]))
        code = ("import sys, test_torch_backend_conformance as t; "
                "t._read_through_specs(bytes.fromhex(sys.argv[1]))")
        proc = subprocess.run([sys.executable, "-c", code, pickle.dumps((kv, store)).hex()],
                              env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.split() == ["NetKVStore", "NetBackend", "[1,", "'two']", "{'v':", "3}"]
    finally:
        kv.close()
        store.backend.close()
        server.close()
