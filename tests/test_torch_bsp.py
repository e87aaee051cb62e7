"""The port's BSP layer (`repro_torch.core.bsp`) and shuffle plane
(`repro_torch.storage.shuffle`) against the JAX package's, on the CPU.

Each parity test drives JAX's function and the port's on the same inputs,
made from a numpy seed:

* word count: equal counts, and equal to an in-process ``Counter``;
* terasort: the same splitters, intermediate-object count and sorted output
  blobs (byte for byte); more KV shards lower the hottest shard's virtual
  time (`tests/test_paper_claims.py`);
* the shuffle: ``write_partitions``/``read_partition_column``/
  ``delete_intermediates`` write byte-identical objects with the same
  modelled requests, in the counts `tests/test_writeplane.py` prescribes;
* re-entrancy and adoption (`tests/test_multidriver.py`): a port driver
  SIGKILLed between map and reduce, or between partition and merge, is
  adopted with none lost and none duplicated;
* cross-package data: the port reads what JAX's terasort wrote on shared
  file roots, and JAX reads the port's intermediates;
* `tests/test_system.py`'s map + monolithic reduce.

The port ships functions with the standard ``pickle``: every mapped or
reduced function here is a module-level function (or a partial of one).
"""

import os
import signal
import subprocess
import sys
from collections import Counter
from functools import partial

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import WrenExecutor as JWrenExecutor  # noqa: E402
from repro.core import terasort as jterasort  # noqa: E402
from repro.core import verify_sorted as jverify_sorted  # noqa: E402
from repro.core import word_count as jword_count  # noqa: E402
from repro.storage import FileBackend as JFileBackend  # noqa: E402
from repro.storage import FileKVStore as JFileKVStore  # noqa: E402
from repro.storage import KVStore as JKVStore  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro.storage import shuffle as jshf  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SchedulerConfig,
    WrenExecutor,
    adopt_job,
    jobs,
    mapreduce,
    run_stage,
    terasort,
    verify_sorted,
    word_count,
)
from repro_torch.core import bsp  # noqa: E402
from repro_torch.data import make_documents, shard_corpus, tokenize_line  # noqa: E402
from repro_torch.storage import FileBackend, FileKVStore, KVStore, ObjectStore  # noqa: E402
from repro_torch.storage import REDIS_2017  # noqa: E402
from repro_torch.storage import shuffle as shf  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))


# module-level task functions: the port pickles them by reference
def _plus_one(x):
    return x + 1


def _mod_pairs(n, part):
    return [(x % n, x) for x in part]


def _sum_values(_k, vs):
    return sum(vs)


def _count_words(doc):
    return [(w, 1) for line in doc for w in line.split()]


def _featurize(store, key):
    doc = store.get(key, worker="feat")
    feats = np.zeros(64)
    for line in doc:
        for tok in tokenize_line(line, 64):
            feats[tok] += 1.0
    out_key = key.replace("corpus/", "feats/")
    store.put(out_key, feats, worker="feat")
    return out_key


def _count_submits(wex, counter):
    orig = wex.scheduler.submit_many

    def wrapped(tasks):
        counter.append(len(tasks))
        return orig(tasks)

    wex.scheduler.submit_many = wrapped


# ---------------------------------------------------------------------------
# word count and terasort against the JAX package
# ---------------------------------------------------------------------------

def test_make_documents_equals_jax():
    from repro.data import make_documents as jmake_documents

    for n, lines, seed in ((3, 5, 0), (40, 60, 7)):
        assert make_documents(n, lines, seed=seed) == jmake_documents(n, lines, seed=seed)


def test_word_count_equals_jax_and_an_in_process_count():
    docs = make_documents(12, 6, seed=3)
    with WrenExecutor(num_workers=4) as wex:
        wc = word_count(wex, docs, num_reducers=3)
    with JWrenExecutor(num_workers=4) as jwex:
        jwc = jword_count(jwex, docs, num_reducers=3)
    truth = Counter(w for doc in docs for line in doc for w in line.split())
    assert wc == jwc == dict(truth)


def _put_records(store, prefix, n_files, per_file):
    keys = []
    for i in range(n_files):
        key = f"{prefix}/{i}"
        store.put(key, shf.make_sort_records(per_file, seed=i))
        keys.append(key)
    return keys


def _sort(executor_cls, kv_cls, n_shards, n_parts=6, n_files=6, per_file=120):
    with executor_cls(num_workers=4) as wex:
        keys = _put_records(wex.store, "sin", n_files, per_file)
        kv = kv_cls(num_shards=n_shards, profile=REDIS_2017)
        rep = (terasort if executor_cls is WrenExecutor else jterasort)(
            wex, keys, "sout", n_parts, intermediate=kv)
        outs = {k: bytes(wex.store.get_bytes(k)) for k in wex.store.list("sout")}
        ok = (verify_sorted if executor_cls is WrenExecutor else jverify_sorted)(
            wex.store, "sout")
    return rep, ok, outs


def test_terasort_output_bytes_equal_jax():
    rep, ok, outs = _sort(WrenExecutor, KVStore, 4)
    jrep, jok, jouts = _sort(JWrenExecutor, JKVStore, 4)
    assert ok and jok
    assert rep.n_records == jrep.n_records == 6 * 120
    assert rep.n_intermediate_objects == jrep.n_intermediate_objects == 6 * 6
    assert rep.splitters == jrep.splitters == 5
    assert list(outs) == list(jouts) and len(outs) == 6
    assert outs == jouts  # the sorted partitions, blob for blob


def test_more_kv_shards_lower_the_hottest_shard():
    rep1, ok1, _ = _sort(WrenExecutor, KVStore, 1)
    rep8, ok8, _ = _sort(WrenExecutor, KVStore, 8)
    assert ok1 and ok8
    assert rep8.hottest_shard_vtime < rep1.hottest_shard_vtime


# ---------------------------------------------------------------------------
# the shuffle plane: bytes and modelled requests equal to JAX's
# ---------------------------------------------------------------------------

def _parts(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "records":  # terasort: lists of 100-byte numpy rows
        recs = rng.integers(0, 256, size=(90, 100), dtype=np.uint8)
        return shf.range_partition(list(recs), [bytes([64] * 10), bytes([160] * 10)],
                                   key=shf.record_sort_key)
    words = [f"w{int(i)}" for i in rng.integers(0, 40, size=200)]  # word count's pairs
    return shf.hash_partition(list(Counter(words).items()), 5)


def _ledger(store):
    return [(r.worker, r.op, r.key, r.nbytes) for r in store.ledger.records()]


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("kind", ["records", "pairs"])
@pytest.mark.parametrize("plane", ["obj", "kv"])
def test_shuffle_intermediates_byte_identical_with_equal_requests(tmp_path, kind, plane):
    """Both packages' shuffle verbs over their own file roots: the same
    files after the maps' writes, the same columns read back, the same
    ledger records (worker, op, key, bytes), and the request counts of
    `tests/test_writeplane.py`: a map's fan-out one ``mput`` (one ``mset``
    per shard touched on the KV), a reduce's fan-in one batched read, the
    GC one batched delete behind its tombstone."""
    parts = [_parts(kind, m) for m in range(3)]
    n_parts = len(parts[0])
    out = {}
    for name, Obj, Back, KV, sh in (
        ("port", ObjectStore, FileBackend, FileKVStore, shf),
        ("jax", JObjectStore, JFileBackend, JFileKVStore, jshf),
    ):
        root = tmp_path / name
        store = (KV(str(root), num_shards=2, fsync="never") if plane == "kv"
                 else Obj(backend=Back(str(root), fsync="never")))
        store.ledger.clear()
        for m, p in enumerate(parts):
            assert sh.write_partitions(store, "job", m, p, worker=f"m{m}") == n_parts
        writes = [r for r in store.ledger.records() if r.op in ("put", "mput", "set", "mset")]
        if plane == "kv":
            assert {r.op for r in writes} == {"mset"}
            assert len(writes) <= 3 * store.num_shards
        else:
            assert [r.op for r in writes] == ["mput"] * 3
        files = _files(root)
        before = len(store.ledger.records())
        cols = [sh.read_partition_column(store, "job", 3, q, worker=f"r{q}")
                for q in range(n_parts)]
        reads = store.ledger.records()[before:]
        assert len(reads) == n_parts if plane == "obj" else len(reads) <= n_parts * 2
        assert sh.delete_intermediates(store, "job", 3, n_parts, worker="gc") == 3 * n_parts
        out[name] = (files, cols, _ledger(store))
        if plane == "kv":
            store.close()
    (files, cols, ledger), (jfiles, jcols, jledger) = out["port"], out["jax"]
    assert list(files) == list(jfiles) and len(files) > 0
    for f in files:
        assert files[f] == jfiles[f], f
    for a, b in zip(cols, jcols, strict=True):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(x, y) if kind == "records" else x == y
    assert ledger == jledger


@pytest.mark.parametrize("kind", ["obj", "kv"])
def test_delete_intermediates_retires_column_space(kind):
    store = KVStore(num_shards=2) if kind == "kv" else ObjectStore()
    n_maps, n_parts = 3, 4
    for m in range(n_maps):
        shf.write_partitions(store, "gcjob", m, [[m, p] for p in range(n_parts)])
    assert shf.delete_intermediates(store, "gcjob", n_maps, n_parts) == n_maps * n_parts

    def exists(key):
        return store.exists(key) if kind == "kv" else store.backend.exists(key)

    assert not any(exists(shf.intermediate_key("gcjob", m, p))
                   for m in range(n_maps) for p in range(n_parts))
    # a zombie map attempt after the GC is dropped; clearing the tombstone
    # revives the job name
    assert shf.write_partitions(store, "gcjob", 0, [[9], [9]]) == 0
    assert not exists(shf.intermediate_key("gcjob", 0, 0))
    shf.clear_gc_tombstone(store, "gcjob")
    assert shf.write_partitions(store, "gcjob", 0, [[9], [9]]) == 2


def test_mapreduce_and_terasort_leave_no_shuffle_intermediates():
    docs = [[f"w{i % 5} w{(i * 3) % 7}" for i in range(10)] for _ in range(4)]
    with WrenExecutor(num_workers=4) as wex:
        out = mapreduce(wex, _count_words, _sum_values, docs, num_reducers=3)
        assert sum(out.values()) == sum(len(l.split()) for d in docs for l in d)
        assert wex.store.list("shuffle/") == []
        keys = _put_records(wex.store, "tin", 3, 40)
        kv = KVStore(num_shards=2)
        rep = terasort(wex, keys, "tout", 4, intermediate=kv)
        assert verify_sorted(wex.store, "tout") and rep.n_records == 3 * 40
        for sh in kv._shards:
            assert not any(k.startswith("shuffle/") for k in sh.data)


# ---------------------------------------------------------------------------
# cross-package data on shared file roots
# ---------------------------------------------------------------------------

def test_port_reads_what_jax_terasort_and_shuffle_wrote(tmp_path):
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    jkv = JFileKVStore(kv_root, num_shards=4, fsync="never")
    jstore = JObjectStore(backend=JFileBackend(obj_root, fsync="never"))
    jwex = JWrenExecutor(store=jstore, kv=jkv, num_workers=4)
    try:
        keys = _put_records(jstore, "xin", 4, 50)
        rep = jterasort(jwex, keys, "xout", 5, intermediate=jkv)
        # intermediates of another job, left in place for the reader
        for m in range(4):
            jshf.write_partitions(jkv, "xjob", m, _parts("records", m))
    finally:
        jwex.shutdown()
    kv = FileKVStore(kv_root, num_shards=4, fsync="never")
    store = ObjectStore(backend=FileBackend(obj_root, fsync="never"))
    try:
        assert verify_sorted(store, "xout")
        outs = [store.get(k) for k in store.list("xout")]
        assert sum(len(o) for o in outs) == rep.n_records == 4 * 50
        every = np.concatenate([store.get(k) for k in keys])
        np.testing.assert_array_equal(np.concatenate(outs), every[np.argsort(
            [shf.record_sort_key(r) for r in every], kind="stable")])
        for q in range(3):
            col = shf.read_partition_column(kv, "xjob", 4, q)
            exp = [r for m in range(4) for r in _parts("records", m)[q]]
            assert len(col) == len(exp) and all(np.array_equal(a, b) for a, b in zip(col, exp))
        # and the reverse: JAX reads an intermediate the port writes
        shf.write_partitions(store, "pjob", 0, _parts("records", 9))
        jcol = jshf.read_partition_column(jstore, "pjob", 1, 1)
        assert all(np.array_equal(a, b) for a, b in zip(jcol, _parts("records", 9)[1]))
    finally:
        kv.close()
        jkv.close()


def test_port_reads_a_jax_blob_without_jax():
    """JAX's raw blob pickles a ``PyTreeDef`` in its descriptor; the port
    reads it through its stand-in, in a process that never imports jax."""
    from repro.storage import serialization as jser

    value = {"recs": list(shf.make_sort_records(5, seed=1)), "n": (np.int64(5), None)}
    blob = jser.dumps(value)
    code = (
        "import sys; from repro_torch.storage import serialization as s\n"
        f"v = s.loads(bytes.fromhex({blob.hex()!r}))\n"
        "assert len(v['recs']) == 5 and v['recs'][0].shape == (100,) and v['n'][1] is None\n"
        "assert s.dumps(v) == bytes.fromhex(" + repr(blob.hex()) + ")\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# re-entrancy, adoption (the port's twins of tests/test_multidriver.py)
# ---------------------------------------------------------------------------

def test_run_stage_reentrant_zero_resubmits():
    submits = []
    with WrenExecutor(num_workers=2) as wex:
        _count_submits(wex, submits)
        assert run_stage(wex, _plus_one, [1, 2, 3], job_id="rs-re") == [2, 3, 4]
        assert sum(submits) == 3
        assert run_stage(wex, _plus_one, [1, 2, 3], job_id="rs-re") == [2, 3, 4]
        assert sum(submits) == 3  # the recorded barrier: no task traffic
        rec = jobs.driver_record(wex.kv, "rs-re")
        assert rec["expires"] == 0.0 and rec["term"] == 1
        run_stage(wex, _plus_one, [1, 2, 3], job_id="rs-re", gc=True)
        assert wex.kv.scan("sched/job/rs-re/") == []


def test_mapreduce_reentrant_resumes_from_barriers():
    submits = []
    with WrenExecutor(num_workers=2) as wex:
        _count_submits(wex, submits)
        expected = {k: sum(x for x in range(20) if x % 4 == k) for k in range(4)}
        parts = [list(range(0, 10)), list(range(10, 20))]
        out = mapreduce(wex, partial(_mod_pairs, 4), _sum_values, parts, 4, job_id="mr-re")
        assert out == expected
        assert sum(submits) == 2 + 4  # maps + reduces, exactly once
        assert wex.kv.scan("sched/job/mr-re/") == []


def test_task_functions_pickle_to_the_same_bytes():
    """Task ids and function keys are content hashes of the pickled task:
    the partials carry no uuid, time or process-local id of their own, so
    the same task pickles to the same bytes again."""
    import pickle

    store, kv = ObjectStore(), KVStore(num_shards=2)
    for make in (lambda: bsp._mr_map_task(partial(_mod_pairs, 3), store, "j", 3),
                 lambda: bsp._mr_reduce_task(_sum_values, kv, "j", 2),
                 lambda: bsp._sort_sample_task(store, 64),
                 lambda: bsp._sort_partition_task(store, kv, "j", [b"a" * 10]),
                 lambda: bsp._sort_merge_task(store, kv, "j", 2, "out")):
        assert pickle.dumps(make()) == pickle.dumps(make())
    with WrenExecutor(num_workers=1) as wex, pytest.raises(TypeError, match="pickle"):
        mapreduce(wex, lambda d: [], _sum_values, [[1]], 1)


_KILL_PARTS = [list(range(0, 10)), list(range(10, 20)), list(range(20, 30))]
_KILL_REDUCERS = 5


def _kill_driver_main(kv_root, obj_root, kind):
    """Child entry: submit a job through the port, SIGKILL this process the
    instant the chosen stage barrier commits (map -> reduce for mapreduce,
    partition -> merge for terasort)."""
    kv = FileKVStore(kv_root, num_shards=2, fsync="never")
    store = ObjectStore(backend=FileBackend(obj_root, fsync="never"))
    wex = WrenExecutor(store=store, kv=kv, num_workers=2,
                       scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0))
    kill_after = {"mr": 0, "sort": 1}[kind]
    orig_barrier = bsp._stage_barrier

    def killing_barrier(wex_, job, idx, plan, outputs, **kw):
        out = orig_barrier(wex_, job, idx, plan, outputs, **kw)
        if idx == kill_after:
            kv.set("ctl/barrier-committed", 1, worker="child")
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    bsp._stage_barrier = killing_barrier
    if kind == "mr":
        bsp.mapreduce(wex, partial(_mod_pairs, _KILL_REDUCERS), _sum_values, _KILL_PARTS,
                      _KILL_REDUCERS, job_id="kill-mr")
    else:
        rng = np.random.default_rng(7)
        keys = []
        for i in range(3):
            key = f"sortin/part{i}"
            store.put(key, rng.integers(0, 256, size=(40, 100), dtype=np.uint8), worker="gen")
            keys.append(key)
        bsp.terasort(wex, keys, "sorted", num_partitions=4, intermediate=store,
                     job_id="kill-sort")
    raise SystemExit("driver survived past the kill barrier")


def _adopt_after_kill(tmp_path, kind):
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    code = (f"import test_torch_bsp as t; t._kill_driver_main({kv_root!r}, {obj_root!r}, "
            f"{kind!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9, proc.stdout + proc.stderr
    kv = FileKVStore(kv_root, num_shards=2, fsync="never")
    store = ObjectStore(backend=FileBackend(obj_root, fsync="never"))
    assert kv.get("ctl/barrier-committed") == 1
    wex = WrenExecutor(store=store, kv=kv, num_workers=2,
                       scheduler_config=SchedulerConfig(driver_lease_timeout_s=1.0))
    return kv, store, wex


def test_driver_sigkilled_between_map_and_reduce_is_adopted(tmp_path):
    kv, store, wex = _adopt_after_kill(tmp_path, "mr")
    try:
        submits = []
        _count_submits(wex, submits)
        out = adopt_job(wex, "kill-mr", wait_timeout_s=30.0, timeout_s=120.0)
        allx = [x for part in _KILL_PARTS for x in part]
        assert out == {k: sum(x for x in allx if x % _KILL_REDUCERS == k)
                       for k in range(_KILL_REDUCERS)}
        assert sum(submits) == _KILL_REDUCERS  # the map barrier honoured
        assert kv.get("sched/finished/kill-mr") is not None
        assert kv.scan("sched/job/kill-mr/") == []
        assert store.list("shuffle/") == [] and store.list("result/") == []
    finally:
        wex.shutdown()
        kv.close()


def test_driver_sigkilled_between_partition_and_merge_terasort(tmp_path):
    kv, store, wex = _adopt_after_kill(tmp_path, "sort")
    try:
        submits = []
        _count_submits(wex, submits)
        report = adopt_job(wex, "kill-sort", wait_timeout_s=30.0, timeout_s=120.0)
        assert report is not None and report.n_records == 3 * 40
        assert sum(submits) == 4  # only the merge tasks
        assert verify_sorted(store, "sorted")
        outs = np.concatenate([store.get(k) for k in store.list("sorted")])
        ins = np.concatenate([store.get(f"sortin/part{i}") for i in range(3)])
        assert len(outs) == 3 * 40  # none lost, none written twice
        assert sorted(map(bytes, outs)) == sorted(map(bytes, ins))
        assert kv.scan("sched/job/kill-sort/") == [] and store.list("shuffle/") == []
    finally:
        wex.shutdown()
        kv.close()


def test_adopt_job_returns_none_for_finished_job():
    with WrenExecutor(num_workers=2) as wex:
        run_stage(wex, _plus_one, [1], job_id="done-job", gc=True)
        assert adopt_job(wex, "done-job", wait_timeout_s=5.0) is None
        assert wex.kv.scan("sched/job/done-job/") == []


def test_adopt_job_times_out_on_live_driver():
    store, kv = ObjectStore(), KVStore(num_shards=2)
    wex_a = WrenExecutor(store=store, kv=kv, num_workers=1)
    wex_b = WrenExecutor(store=store, kv=kv, num_workers=1)
    try:
        assert wex_a.register_driver("held-job") == 1
        with pytest.raises(TimeoutError):
            adopt_job(wex_b, "held-job", wait_timeout_s=0.3)
        wex_a.release_driver("held-job")
        assert adopt_job(wex_b, "held-job", wait_timeout_s=5.0) is None
    finally:
        wex_a.shutdown()
        wex_b.shutdown()


# ---------------------------------------------------------------------------
# tests/test_system.py's map + monolithic reduce
# ---------------------------------------------------------------------------

def test_map_then_monolithic_reduce():
    with WrenExecutor(num_workers=4) as wex:
        store = wex.store
        keys = shard_corpus(store, "corpus", make_documents(8, 5, seed=1))
        feat_keys = run_stage(wex, partial(_featurize, store), keys)
        X = np.stack([store.get(k) for k in feat_keys])
        w = np.linalg.lstsq(X, np.ones(len(X)), rcond=None)[0]
        assert np.isfinite(w).all() and X.sum() == sum(
            len(l.split()) for d in make_documents(8, 5, seed=1) for l in d)
