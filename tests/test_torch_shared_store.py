"""The JAX package and the port over one pair of file roots, on the CPU.

1. The same operations through JAX's ``FileKVStore``/``FileBackend`` and
   through the port's write the same files byte for byte (shard logs,
   frames, the ``.watch-seq`` ledger, objects), and each package reads the
   other's directory (and one both write, interleaved).
2. A JAX ``ContinuousEngine`` (this process) and a torch one (a subprocess)
   drain one queue on one pair of roots: the reduced llama3-8b in fp32, the
   same weights (JAX's, through `bridge.params_from_jax`).  Every request is
   served exactly once, and its greedy tokens equal JAX's single-engine
   `Engine.generate` tokens.
3. A torch worker subprocess SIGKILLed mid-stream is re-served by a torch
   survivor: none lost, none duplicated, the victim's published results
   untouched (the twin of `tests/test_serve_continuous.py`'s
   ``test_sigkill_engine_zero_lost_zero_duplicated``).
4. The port's serve CLI as a worker over shared roots: ``READY``, the
   stats line, exit 0 on idle, and the flags' pairing.

Each subprocess has its own timeout of about 30 s (60 s where it serves).
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.storage import FileBackend as JFileBackend  # noqa: E402
from repro.storage import FileKVStore as JFileKVStore  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig  # noqa: E402
from repro_torch.serve import request_plane as rp  # noqa: E402
from repro_torch.storage import FileBackend, FileKVStore, ObjectStore  # noqa: E402
from repro_torch.storage.kv_store import iter_frames  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SUBPROCESS_TIMEOUT_S = 30
SERVE_TIMEOUT_S = 60
ARCH = "llama3-8b"
SCFG = dict(max_batch=2, max_len=64, max_new_tokens=8, decode_chunk=2, lease_timeout_s=1.0)
# no engine dies while two drain one queue: a lease that outlasts any stall
# (a JAX prefill compiling a new shape on a loaded host) keeps a live
# engine's requests from being reaped and served twice
SHARED_LEASE_S = 60.0


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _spawn(*args, module=None) -> subprocess.Popen:
    head = ["-m", module] if module else [os.path.abspath(__file__)]
    return subprocess.Popen([sys.executable, *head, *args], env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc, what, timeout=SUBPROCESS_TIMEOUT_S):
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"{what} did not finish in {timeout} s")
    assert proc.returncode == 0, f"{what} exited {proc.returncode}: {out[-3000:]}"
    return out


def _await_line(proc, prefix, what, timeout=SUBPROCESS_TIMEOUT_S):
    """Read the child's lines until one starts with ``prefix``."""
    got = []
    done = threading.Event()

    def read():
        for line in proc.stdout:
            got.append(line)
            if line.startswith(prefix):
                break
        done.set()

    threading.Thread(target=read, daemon=True).start()
    if not done.wait(timeout) or not got or not got[-1].startswith(prefix):
        proc.kill()
        raise AssertionError(f"{what} printed no {prefix!r} line: {''.join(got)[-3000:]}")
    return got[-1]


# ---------------------------------------------------------------------------
# 1. one on-disk format
# ---------------------------------------------------------------------------

def _ops(kv, store):
    """The request plane's verbs and a few of every kind, on one package's
    stores."""
    kv.set("cfg", {"a": [1, 2.5, "x"], "b": None})
    kv.mset({f"m/{i}": i for i in range(5)})
    kv.rpush("serve/q/0", "r0", "r1", "r2")
    kv.rpush_many({"serve/q/0": ["r3"], "serve/q/1": ["r4"]})
    assert kv.lpop_n("serve/q/0", 2) == ["r0", "r1"]
    kv.incr("n", 3)
    kv.setnx("claim", "first")
    kv.delete("m/4")
    kv.mdel(["m/3"])
    store.put("serve/req/r0", {"prompt": [5, 6, 7], "ts": 1.5, "max_new": 4})
    store.put_many({f"result/job/t{i}": {"v": i} for i in range(10)})
    store.put("serve/done/r0", {"tokens": [1, 2], "engine": "e"}, if_absent=True)
    store.put_bytes("ckpt/run/v00000000/leaf/00000/0000", bytes(range(256)))
    store.delete("result/job/t9")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def _expect(kv, store):
    assert kv.get("cfg") == {"a": [1, 2.5, "x"], "b": None}
    assert kv.mget([f"m/{i}" for i in range(5)]) == [0, 1, 2, None, None]
    assert kv.lrange("serve/q/0") == ["r2", "r3"] and kv.lrange("serve/q/1") == ["r4"]
    assert kv.get("n") == 3 and kv.get("claim") == "first"
    assert store.get("serve/req/r0") == {"prompt": [5, 6, 7], "ts": 1.5, "max_new": 4}
    assert store.list("result/job/") == sorted(f"result/job/t{i}" for i in range(9))
    assert store.get("serve/done/r0") == {"tokens": [1, 2], "engine": "e"}
    assert store.get_bytes("ckpt/run/v00000000/leaf/00000/0000") == bytes(range(256))


@pytest.mark.parametrize("engine", ["log", "snapshot"])
def test_both_packages_write_the_same_bytes_and_read_each_other(tmp_path, engine):
    opts = dict(num_shards=2, fsync="never", engine=engine)
    handles = {}
    for name, KV, Backend, Store in (("jax", JFileKVStore, JFileBackend, JObjectStore),
                                     ("torch", FileKVStore, FileBackend, ObjectStore)):
        kv = KV(str(tmp_path / name / "kv"), compact_min_bytes=1 << 30, **opts)
        store = Store(backend=Backend(str(tmp_path / name / "obj"), fsync="never"))
        _ops(kv, store)
        handles[name] = (kv, store)
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert jfiles.keys() == tfiles.keys()
    for rel in jfiles:
        assert jfiles[rel] == tfiles[rel], rel
    # the frames decode identically in either package's decoder
    from repro.storage.kv_store import iter_frames as j_iter_frames

    for rel, blob in jfiles.items():
        if rel.endswith(".watch-seq") or rel.endswith(".log"):
            start = 12 if rel.endswith(".log") else 0  # past the log header
            assert list(j_iter_frames(blob, start)) == list(iter_frames(blob, start)), rel
    # each package reads the other's directory, through fresh handles
    _expect(FileKVStore(str(tmp_path / "jax" / "kv"), **opts),
            ObjectStore(backend=FileBackend(str(tmp_path / "jax" / "obj"))))
    _expect(JFileKVStore(str(tmp_path / "torch" / "kv"), **opts),
            JObjectStore(backend=JFileBackend(str(tmp_path / "torch" / "obj"))))
    for kv, store in handles.values():
        kv.close()
        store.backend.close()


def test_interleaved_writers_of_both_packages_share_one_root(tmp_path):
    jkv = JFileKVStore(str(tmp_path / "kv"), num_shards=2, compact_min_bytes=2048)
    tkv = FileKVStore(str(tmp_path / "kv"), num_shards=2, compact_min_bytes=2048)
    jst = JObjectStore(backend=JFileBackend(str(tmp_path / "obj")))
    tst = ObjectStore(backend=FileBackend(str(tmp_path / "obj")))
    try:
        for i in range(60):  # past the compaction threshold: both packages compact
            (jkv if i % 2 else tkv).rpush("q", i)
            (tkv if i % 3 else jkv).incr("ctr", 1)
        tkv.compact_now()
        jkv.compact_now()
        assert jkv.lrange("q") == tkv.lrange("q") == list(range(60))
        assert jkv.get("ctr") == tkv.get("ctr") == 60
        # a first-writer-wins race between the packages: exactly one wins each key
        wins = [jst.put(f"race/{i}", "jax", if_absent=True) for i in range(0, 20, 2)]
        wins += [tst.put(f"race/{i}", "torch", if_absent=True) for i in range(20)]
        assert sum(wins) == 20
        assert [tst.get(f"race/{i}") for i in range(4)] == ["jax", "torch", "jax", "torch"]
        # a JAX blpop is woken by a torch push through the other package's watcher
        got = []
        th = threading.Thread(target=lambda: got.append(jkv.blpop("wake", timeout_s=10.0)))
        th.start()
        time.sleep(0.25)
        tkv.rpush("wake", "from torch")
        th.join(timeout=10)
        assert got == ["from torch"]
    finally:
        for h in (jkv, tkv, jst.backend, tst.backend):
            h.close()


# ---------------------------------------------------------------------------
# 2-3. engines of both packages over one queue
# ---------------------------------------------------------------------------

_PARAMS = {}


def _jax_params():
    if "jp" not in _PARAMS:
        _PARAMS["jp"] = jinit_params(JCONFIGS[ARCH].reduced(), jax.random.PRNGKey(0))
    return _PARAMS["jp"]


def _prompts(n, seed):
    cfg = CONFIGS[ARCH].reduced()
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 12))).tolist()
            for _ in range(n)]


def _jax_reference(prompts):
    """JAX's single-engine greedy tokens, one prompt at a time."""
    eng = JEngine(JCONFIGS[ARCH].reduced(), _jax_params(), JServeConfig(**SCFG))
    return [eng.generate(jnp.asarray([p], jnp.int32))[0].tolist() for p in prompts]


def _save_params(tmp_path):
    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, _jax_params()), f)
    return str(path)


def _torch_engine(params_path, lease_s=SCFG["lease_timeout_s"]):
    with open(params_path, "rb") as f:
        tp = params_from_jax(pickle.load(f), CONFIGS[ARCH].reduced())
    scfg = ServeConfig(**dict(SCFG, lease_timeout_s=float(lease_s)))
    return ContinuousEngine(CONFIGS[ARCH].reduced(), tp, scfg, device="cpu")


def _engine_main(params_path, kv_root, obj_root, engine_id, lease_s):
    """A torch engine over the roots until the queue stays empty 3 s."""
    eng = _torch_engine(params_path, lease_s)
    kv, store = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
    print("READY", flush=True)
    stats = eng.run(store, kv, engine_id=engine_id, idle_timeout_s=3.0)
    print("STATS " + json.dumps(stats), flush=True)


def test_jax_and_torch_engines_drain_one_queue(tmp_path):
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    jkv = JFileKVStore(kv_root, num_shards=2)
    jstore = JObjectStore(backend=JFileBackend(obj_root))
    jeng = JContinuousEngine(JCONFIGS[ARCH].reduced(), _jax_params(),
                             JServeConfig(**dict(SCFG, lease_timeout_s=SHARED_LEASE_S)))
    jeng.admit([("warm", [1, 2, 3], 2)])  # compile before the queue fills
    while jeng.n_live():
        jeng.step_chunk()
    for k in jeng.stats:
        jeng.stats[k] = 0
    proc = _spawn("engine", _save_params(tmp_path), kv_root, obj_root, "torch",
                  str(SHARED_LEASE_S))
    try:
        _await_line(proc, "READY", "the torch engine")
        prompts = _prompts(10, seed=3)
        ids = [f"s{i}" for i in range(len(prompts))]
        # the port's client, as a torch user would submit
        tkv, tstore = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
        for r, p in zip(ids, prompts):
            rp.submit(tstore, tkv, r, p)
        jstats = jeng.run(jstore, jkv, engine_id="jax", idle_timeout_s=3.0)
        out = _finish(proc, "the torch engine", SERVE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    tstats = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
    res = rp.get_results(tstore, ids, timeout_s=10)
    # served exactly once: one result object each, the two engines' counts add up
    assert sorted(tstore.list("serve/done/")) == sorted(rp.done_key(r) for r in ids)
    assert jstats["served"] + tstats["served"] == len(ids)
    assert jstats["served"] >= 1 and tstats["served"] >= 1, (jstats, tstats)
    assert {res[r]["engine"] for r in ids} == {"jax", "torch"}
    for r, exp in zip(ids, _jax_reference(prompts)):
        assert res[r]["tokens"] == exp, (r, res[r]["engine"])
    for h in (jkv, tkv, jstore.backend, tstore.backend):
        h.close()


def _victim_main(params_path, kv_root, obj_root, engine_id):
    """A throttled torch serve loop (one decode step a tick) so that the
    parent can SIGKILL it while requests are mid-stream with live leases."""
    eng = _torch_engine(params_path)
    kv, store = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
    print("READY", flush=True)
    while True:
        free = eng.free_slots()
        if free:
            leased = rp.lease_requests(store, kv, engine_id, len(free), lease_timeout_s=1.0,
                                       wait_s=0.2)
            if leased:
                eng.admit([(r, b["prompt"], int(b.get("max_new", 8))) for r, b in leased])
        if eng.n_live() == 0:
            continue
        finished, chunks = eng.step_chunk(1)
        rp.stream_chunks(kv, chunks, worker=engine_id)
        rp.heartbeat_leases(kv, engine_id, eng.live_req_ids(), lease_timeout_s=1.0)
        if finished:
            rp.publish_results(store, kv, engine_id,
                               {r: {"tokens": s.out} for r, s in finished.items()})
        time.sleep(0.12)


def _live_leases(kv, engine_id):
    now = time.time()
    keys = kv.scan(rp.LEASE_PREFIX)
    return [k for k, rec in zip(keys, kv.mget(keys))
            if rec and rec["engine"] == engine_id and float(rec["expires"]) > now]


def test_sigkilled_torch_worker_is_reserved_none_lost_none_duplicated(tmp_path):
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    kv, store = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
    prompts = _prompts(6, seed=11)
    ids = [f"k{i}" for i in range(len(prompts))]
    for r, p in zip(ids, prompts):
        rp.submit(store, kv, r, p)
    params_path = _save_params(tmp_path)
    proc = _spawn("victim", params_path, kv_root, obj_root, "victim")
    try:
        _await_line(proc, "READY", "the victim")
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while time.monotonic() < deadline:  # kill once a result is out and work is leased
            live = _live_leases(kv, "victim")
            if live and 1 <= len(store.exists_many([rp.done_key(r) for r in ids])) < len(ids):
                break
            time.sleep(0.02)
        else:
            pytest.fail("the victim never reached a mid-stream state")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL and live  # killed holding leases
    before = {k: store.get(k) for k in store.exists_many([rp.done_key(r) for r in ids])}
    assert before and len(before) < len(ids)

    # the survivor alone: a long lease of its own (its reap at the start of
    # each run still takes the victim's lapsed 1 s leases)
    survivor = _torch_engine(params_path, SHARED_LEASE_S)
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while time.monotonic() < deadline:
        survivor.run(store, kv, engine_id="survivor", idle_timeout_s=2.0)
        if len(store.exists_many([rp.done_key(r) for r in ids])) == len(ids):
            break
    res = rp.get_results(store, ids, timeout_s=10)
    for r, exp in zip(ids, _jax_reference(prompts)):  # none lost, each correct
        assert res[r]["tokens"] == exp, r
    for k, rec in before.items():  # none duplicated: the victim's results stand
        assert store.get(k) == rec and rec["engine"] == "victim", k
    assert survivor.stats["served"] == len(ids) - len(before)
    kv.close()
    store.backend.close()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_an_engine_killed_between_pop_and_lease_loses_what_it_popped(tmp_path, package):
    """A behaviour of the reference, kept by the port (one protocol on
    shared roots): ``lease_requests`` pops ids off the queue before its
    lease ``eval_many``, so an engine SIGKILLed between the two leaves the
    popped requests nowhere a survivor looks (not queued, no lease to
    reap, no result).  A worker killed right after publishing, as the card
    test of two workers does, can land there."""
    if package == "jax":
        from repro.serve import request_plane as plane

        kv = JFileKVStore(str(tmp_path / "kv"), num_shards=2, fsync="never")
        store = JObjectStore(backend=JFileBackend(str(tmp_path / "obj"), fsync="never"))
    else:
        plane = rp
        kv = FileKVStore(str(tmp_path / "kv"), num_shards=2, fsync="never")
        store = ObjectStore(backend=FileBackend(str(tmp_path / "obj"), fsync="never"))
    ids = ["p0", "p1", "p2"]
    for r in ids:
        plane.submit(store, kv, r, [1, 2, 3])
    popped = kv.lpop_n(plane.queue_key(0), 2, worker="victim")  # then the SIGKILL
    assert popped == ["p0", "p1"]
    assert plane.reap_expired(store, kv, now=time.time() + 60, worker="survivor") == 0
    won = plane.lease_requests(store, kv, "survivor", 4, lease_timeout_s=60)
    assert [r for r, _ in won] == ["p2"]
    for r in popped:  # lost: no queue entry, lease or result names them
        assert kv.get(plane.lease_key(r)) is None
        assert not store.exists_many([plane.done_key(r)])
    assert kv.lrange(plane.queue_key(0), 0, -1) == []
    kv.close()
    store.backend.close()


# ---------------------------------------------------------------------------
# 4. the serve CLI over shared roots
# ---------------------------------------------------------------------------

def test_serve_cli_worker_over_shared_roots(tmp_path):
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    proc = _spawn("--arch", ARCH, "--reduced", "--device", "cpu", "--kv-root", kv_root,
                  "--obj-root", obj_root, "--engine-id", "cli", "--idle-timeout", "2",
                  "--batch", "2", "--max-len", "64", "--new-tokens", "6",
                  module="repro_torch.launch.serve")
    try:
        assert _await_line(proc, "READY", "the CLI worker").strip() == "READY cli"
        kv, store = FileKVStore(kv_root, num_shards=2), ObjectStore(backend=FileBackend(obj_root))
        prompts = _prompts(4, seed=5)
        ids = [f"c{i}" for i in range(len(prompts))]
        for r, p in zip(ids, prompts):
            rp.submit(store, kv, r, p)
        out = _finish(proc, "the CLI worker", SERVE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "cli: served 4 requests, 24 tokens" in out
    launches = json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("launches ")).split(" ", 1)[1])
    assert launches == dict.fromkeys(["decode_attention", "flash_attention", "ssd", "mlstm"], 0)
    res = rp.get_results(store, ids, timeout_s=10)
    # the CLI's weights: init_params at seed 0, as in this process
    cfg = CONFIGS[ARCH].reduced()
    eng = Engine(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                 ServeConfig(max_batch=2, max_len=64, max_new_tokens=6), device="cpu")
    for r, p in zip(ids, prompts):
        assert res[r]["tokens"] == eng.generate([p])[0].tolist(), r
    kv.close()
    store.backend.close()


@pytest.mark.parametrize("flags", [["--kv-root", "K"], ["--obj-root", "O"], []])
def test_serve_cli_root_flags_come_in_pairs(flags):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
                           "--device", "cpu", *flags], env=_env(), capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 2
    assert ("must be given together" if flags else "no shared roots") in proc.stderr


if __name__ == "__main__":
    role, args = sys.argv[1], sys.argv[2:]
    if role == "engine":
        _engine_main(*args)
    elif role == "victim":
        _victim_main(*args)
    else:
        raise SystemExit(f"unknown role {role!r}")
