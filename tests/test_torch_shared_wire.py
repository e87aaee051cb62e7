"""One ``repro-kvd`` wire, both packages, on the CPU.

1. The port's clients against JAX's daemon, and JAX's clients against the
   port's, beside a client of the daemon's own package: the plain and
   batched verbs, payloads of 64 KiB and more (buffer frames), evals of the
   runtime (one returns ``DELETE``: a fenced lease release), pushed wakes
   across packages; the port's executor and parameter server over JAX's
   daemon.
2. Either daemon restarts on the other's data root and serves every key.
3. A JAX ``ContinuousEngine`` (this process) and a torch one (a
   subprocess) drain one queue through the port's daemon (a subprocess,
   its CLI): every request published once, greedy tokens equal to JAX's
   single-engine tokens (the reduced llama3-8b in fp32, JAX's weights).
4. What the wire cannot carry, pinned: an eval function outside both
   packages that returns the port's ``DELETE`` makes a JAX daemon store
   the sentinel; a global with no JAX twin makes a JAX daemon drop the
   connection, so the port's call is resent until the client closes; a
   daemon's log names the classes of stored values by its own package.
   (A JAX client's closure on the port's daemon: `test_torch_net_protocol.py`.)

Every subprocess wait has its own timeout (``START_TIMEOUT_S`` for a
daemon's ``LISTENING`` line, ``SERVE_TIMEOUT_S`` for the torch engine).
"""

import functools
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
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import request_plane as jrp  # noqa: E402
from repro.storage import NetBackend as JNetBackend  # noqa: E402
from repro.storage import NetKVStore as JNetKVStore  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro.storage.net_server import KVDServer as JKVDServer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.core import scheduler  # noqa: E402
from repro_torch.serve import ContinuousEngine, ServeConfig  # noqa: E402
from repro_torch.serve import request_plane as rp  # noqa: E402
from repro_torch.storage import DELETE, NetBackend, NetKVStore, ObjectStore  # noqa: E402
from repro_torch.storage.net_server import KVDServer  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
START_TIMEOUT_S = 60
STOP_TIMEOUT_S = 10
SERVE_TIMEOUT_S = 90
ARCH = "llama3-8b"
SCFG = dict(max_batch=2, max_len=64, max_new_tokens=8, decode_chunk=2, lease_timeout_s=1.0)
# two live engines drain one queue: a lease that outlasts any stall (a JAX
# prefill compiling a new shape on a loaded host) keeps a live engine's
# requests from being reaped and served twice (tests/test_torch_shared_store.py)
SHARED_LEASE_S = 60.0
BIG = bytes(range(256)) * 300  # 76,800 B: over the 64 KiB buffer-frame threshold

PACKAGES = {
    "torch": dict(kv=NetKVStore, backend=NetBackend, store=ObjectStore, server=KVDServer,
                  sched=scheduler),
    "jax": dict(kv=JNetKVStore, backend=JNetBackend, store=JObjectStore, server=JKVDServer,
                sched=jscheduler),
}


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _clients(pkg, address):
    p = PACKAGES[pkg]
    return p["kv"](address), p["store"](backend=p["backend"](address))


def _close(*handles):
    for h in handles:
        (getattr(h, "backend", None) or h).close()


# ---------------------------------------------------------------------------
# 1. each package's clients against the other's daemon
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client,daemon", [("torch", "jax"), ("jax", "torch")])
def test_clients_of_one_package_against_the_others_daemon(tmp_path, client, daemon):
    own = daemon  # a client of the daemon's own package shares it
    server = PACKAGES[daemon]["server"](str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}",
                                        num_shards=4, fsync="never").start()
    kv, store = _clients(client, server.address)
    okv, ostore = _clients(own, server.address)
    sch = PACKAGES[client]["sched"]
    try:
        # plain and batched verbs
        kv.set("cfg", {"a": [1, 2.5, "x"], "b": None})
        kv.mset({f"m/{i}": i for i in range(6)})
        assert kv.mget(["m/3", "nope", "cfg"], default=-1) == [3, -1, {"a": [1, 2.5, "x"], "b": None}]
        assert kv.setnx("claim", client) and not okv.setnx("claim", own)
        assert kv.incr("n", 3) == 3 and okv.incr("n", 2) == 5
        assert kv.cas("claim", client, "swapped") and okv.get("claim") == "swapped"
        kv.rpush("q", "r0", "r1", "r2")
        assert kv.rpush_many({"q": ["r3"], "q2": ["s0"]}) == {"q": 4, "q2": 1}
        assert kv.lpop_n("q", 2) == ["r0", "r1"] and okv.lpop_n("q", 1) == ["r2"]
        assert kv.lrange("q") == ["r3"] and okv.llen("q2") == 1
        assert sorted(kv.scan("m/")) == sorted(okv.scan("m/")) == [f"m/{i}" for i in range(6)]
        assert kv.mdel(["m/0", "m/1"]) == 2 and not okv.exists("m/0")
        kv.delete("m/2")
        assert okv.get("m/2") is None
        # 64 KiB and more: buffer frames both ways, read by the other package
        buf0 = kv._client.bytes_buffer
        kv.set("kbig", BIG)
        assert bytes(okv.get("kbig")) == BIG and bytes(kv.get("kbig")) == BIG
        assert kv._client.bytes_buffer - buf0 >= 2 * len(BIG)
        store.put_bytes("obig", BIG)
        store.put_many({"o/1": {"v": 1}, "o/2": [1, 2]})
        assert ostore.get_bytes("obig") == BIG and store.get_bytes("obig") == BIG
        assert ostore.get_many(["o/1", "o/2"]) == {"o/1": {"v": 1}, "o/2": [1, 2]}
        assert store.exists_many(["o/1", "o/3"]) == {"o/1"} and sorted(ostore.list("o/")) == ["o/1", "o/2"]
        # the runtime's evals run on the other package's daemon: the twin
        # runs server-side, the caller replays its own copy
        kv.set("decay", 5.0)
        assert kv.eval("decay", functools.partial(sch._fenced_decay, 10.0)) is None
        assert not okv.exists("decay")  # DELETE deleted, on the daemon's side too
        out = {}
        okv.set("lease/t", {"epoch": 3, "expires": 1.0})
        kv.eval("lease/t", functools.partial(sch._lease_drop, 3, None, out))
        assert out["rec"] == {"epoch": 3, "expires": 1.0} and not kv.exists("lease/t")
        assert kv.eval_many({f"c/{i}": sch._incr_counter for i in range(4)}, default=0) == {
            f"c/{i}": 1 for i in range(4)}
        # the request plane's fenced lease release (DELETE) and a pushed wake
        rpm = rp if client == "torch" else jrp
        rpm.submit(store, kv, "req-a", [1, 2, 3])
        (leased,) = rpm.lease_requests(store, kv, "eng", 4, lease_timeout_s=30.0)
        assert leased[0] == "req-a" and okv.get(rpm.lease_key("req-a"))["engine"] == "eng"
        rpm.release_leases(kv, "eng", ["req-a"])
        assert not okv.exists(rpm.lease_key("req-a"))
        got = {}
        waiter = threading.Thread(target=lambda: got.update(v=kv.blpop("wake", timeout_s=20.0)))
        waiter.start()
        time.sleep(0.2)
        okv.rpush("wake", "from-" + own)
        waiter.join(timeout=20)
        assert got.get("v") == "from-" + own
        done = []
        w2 = threading.Thread(target=lambda: done.append(store.wait_keys(["res/x"], timeout_s=20.0)))
        w2.start()
        time.sleep(0.2)
        ostore.put("res/x", 1)
        w2.join(timeout=20)
        assert done and store.fallback_tick_waits == 0
        assert kv._client.reconnects == 0 and okv._client.reconnects == 0
    finally:
        _close(kv, store, okv, ostore)
        server.close()


def _lsq_grad(w, shard):
    X, y = shard
    return 2.0 * X.T @ (X @ w - y) / len(y)


def _triple(x):
    return 3 * x


def test_the_ports_executor_and_parameter_server_over_jax_daemon(tmp_path):
    """The port's scheduler, request fencing and PS updates are all
    by-reference globals with a JAX twin or standard-library functions, so
    the port's runtime runs on JAX's daemon: a map, and one-worker
    HOGWILD! ending on the parameters it ends on in memory."""
    from repro_torch.core import ParameterServer, PSConfig, WrenExecutor, get_all, hogwild_sgd
    from repro_torch.storage import KVStore

    server = JKVDServer(str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}",
                        num_shards=4, fsync="never").start()
    kv, store = _clients("torch", server.address)
    try:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(32, 8))
        shards = [(X, X @ rng.normal(size=8))]
        with WrenExecutor(store=store, kv=kv, num_workers=2) as wex:
            assert get_all(wex.map(_triple, list(range(12))), timeout_s=60) == [
                3 * x for x in range(12)]
            out = []
            for ps_kv in (KVStore(num_shards=4), kv):
                ps = ParameterServer(ps_kv, np.zeros(8), PSConfig(num_blocks=3, max_staleness=2))
                out.append(hogwild_sgd(wex, ps, _lsq_grad, shards, steps_per_worker=5, lr=0.01))
        assert np.array_equal(out[0], out[1])
    finally:
        _close(kv, store)
        server.close()


# ---------------------------------------------------------------------------
# 2. the data roots are interchangeable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_either_daemon_serves_the_others_root(tmp_path, writer, reader):
    root, sock = str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}"
    server = PACKAGES[writer]["server"](root, sock, num_shards=4, fsync="never").start()
    expect = {}
    for pkg in ("torch", "jax"):
        kv, store = _clients(pkg, server.address)
        kv.mset({f"{pkg}/m/{i}": [i, pkg] for i in range(20)})
        kv.rpush(f"{pkg}/q", "a", "b", "c")
        assert kv.lpop_n(f"{pkg}/q", 1) == ["a"]
        kv.set(f"{pkg}/gone", 1.0)
        kv.eval(f"{pkg}/gone", functools.partial(PACKAGES[pkg]["sched"]._fenced_decay, 2.0))
        kv.set(f"{pkg}/kbig", BIG)
        store.put_bytes(f"{pkg}/obig", BIG)
        store.put(f"{pkg}/obj", {"pkg": pkg})
        expect.update({f"{pkg}/m/{i}": [i, pkg] for i in range(20)})
        _close(kv, store)
    server.close()
    server = PACKAGES[reader]["server"](root, sock, num_shards=4, fsync="never").start()
    try:
        for pkg in ("torch", "jax"):
            kv, store = _clients(pkg, server.address)
            keys = sorted(expect)
            assert dict(zip(keys, kv.mget(keys))) == expect
            for p in ("torch", "jax"):
                assert kv.lrange(f"{p}/q") == ["b", "c"] and not kv.exists(f"{p}/gone")
                assert bytes(kv.get(f"{p}/kbig")) == BIG and store.get_bytes(f"{p}/obig") == BIG
                assert store.get(f"{p}/obj") == {"pkg": p}
            data = [k for k in kv.scan("") if not k.startswith("net-ack/")]  # the pop journal
            assert sorted(data) == sorted([*expect, "torch/q", "jax/q", "torch/kbig", "jax/kbig"])
            _close(kv, store)
    finally:
        server.close()


# ---------------------------------------------------------------------------
# 3. a JAX engine and a torch engine drain one queue through one daemon
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


def _await_line(proc, prefix, what, timeout):
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
        proc.wait(timeout=STOP_TIMEOUT_S)
        raise AssertionError(f"{what} printed no {prefix!r} line: {''.join(got)[-3000:]}")
    return got[-1]


def _engine_main(params_path, address, engine_id, lease_s):
    """A torch engine over the daemon until the queue stays empty 3 s."""
    with open(params_path, "rb") as f:
        tp = params_from_jax(pickle.load(f), CONFIGS[ARCH].reduced())
    eng = ContinuousEngine(CONFIGS[ARCH].reduced(), tp,
                           ServeConfig(**dict(SCFG, lease_timeout_s=float(lease_s))), device="cpu")
    kv, store = NetKVStore(address), ObjectStore(backend=NetBackend(address))
    print("READY", flush=True)
    stats = eng.run(store, kv, engine_id=engine_id, idle_timeout_s=3.0)
    print("STATS " + json.dumps(stats), flush=True)


def test_jax_and_torch_engines_drain_one_queue_through_the_ports_daemon(tmp_path):
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.storage.net_server", "--root", str(tmp_path / "kvd"),
         "--uds", str(tmp_path / "kvd.sock"), "--num-shards", "4", "--fsync", "never"],
        env=_env(), text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    engine = None
    try:
        address = _await_line(daemon, "LISTENING", "the port's daemon", START_TIMEOUT_S).split()[1]
        jkv, jstore = _clients("jax", address)
        jeng = JContinuousEngine(JCONFIGS[ARCH].reduced(), _jax_params(),
                                 JServeConfig(**dict(SCFG, lease_timeout_s=SHARED_LEASE_S)))
        jeng.admit([("warm", [1, 2, 3], 2)])  # compile before the queue fills
        while jeng.n_live():
            jeng.step_chunk()
        for k in jeng.stats:
            jeng.stats[k] = 0
        params_path = str(tmp_path / "params.pkl")
        with open(params_path, "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, _jax_params()), f)
        engine = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "engine", params_path, address, "torch",
             str(SHARED_LEASE_S)], env=_env(), text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        _await_line(engine, "READY", "the torch engine", SERVE_TIMEOUT_S)
        prompts = _prompts(10, seed=3)
        ids = [f"w{i}" for i in range(len(prompts))]
        tkv, tstore = _clients("torch", address)  # a torch user submits
        for r, p in zip(ids, prompts):
            rp.submit(tstore, tkv, r, p)
        jstats = jeng.run(jstore, jkv, engine_id="jax", idle_timeout_s=3.0)
        try:
            out = engine.communicate(timeout=SERVE_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            engine.kill()
            raise AssertionError(f"the torch engine did not finish in {SERVE_TIMEOUT_S} s")
        assert engine.returncode == 0, out[-3000:]
        tstats = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
        res = rp.get_results(tstore, ids, timeout_s=10)
        assert sorted(tstore.list("serve/done/")) == sorted(rp.done_key(r) for r in ids)
        assert jstats["served"] + tstats["served"] == len(ids)
        assert jstats["served"] >= 1 and tstats["served"] >= 1, (jstats, tstats)
        assert {res[r]["engine"] for r in ids} == {"jax", "torch"}
        for r, exp in zip(ids, _jax_reference(prompts)):
            assert res[r]["tokens"] == exp, (r, res[r]["engine"])
        _close(jkv, jstore, tkv, tstore)
    finally:
        for proc in (engine, daemon):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=STOP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=STOP_TIMEOUT_S)


# ---------------------------------------------------------------------------
# 4. what the wire cannot carry, pinned
# ---------------------------------------------------------------------------

def _drop_with_the_ports_delete(cur):
    """An eval outside both packages: its ``DELETE`` is the port's."""
    return DELETE


def test_a_jax_daemon_stores_the_ports_delete_from_a_foreign_eval(tmp_path):
    """A JAX daemon tests ``new is DELETE`` against JAX's sentinel, so an
    eval function of neither package (resolved as it is) that returns the
    port's sentinel is stored, not obeyed.  The runtime's evals are not
    affected: they travel as their JAX twins (test 1)."""
    server = JKVDServer(str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}",
                        num_shards=2, fsync="never").start()
    kv = NetKVStore(server.address)
    try:
        kv.set("k", 1)
        assert kv.eval("k", _drop_with_the_ports_delete) is None  # the caller's replay: deleted
        assert kv.exists("k") and kv.get("k") is DELETE  # the daemon: stored
    finally:
        kv.close()
        server.close()


def test_a_jax_daemon_drops_a_global_without_a_jax_twin(tmp_path):
    """The port names its globals ``repro.*``; one with no twin there (here
    ``repro_torch.bridge.params_from_jax``: the JAX package has no
    ``repro.bridge``) fails JAX's decode, which closes the
    connection: the port's client redials and resends, so the call waits
    until the client is closed.  Other connections are unaffected.  No
    eval of the port's runtime names such a global."""
    from repro_torch import bridge

    server = JKVDServer(str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}",
                        num_shards=2, fsync="never").start()
    kv, other = NetKVStore(server.address), NetKVStore(server.address)
    try:
        err = []
        call = threading.Thread(target=lambda: err.append(
            _raises(lambda: kv.eval("k", functools.partial(bridge.params_from_jax, None)))))
        call.start()
        time.sleep(1.0)
        assert call.is_alive() and kv._client.reconnects >= 1
        other.set("k2", 2)
        assert other.get("k2") == 2 and not other.exists("k")
        kv.close()
        call.join(timeout=10)
        assert not call.is_alive() and isinstance(err[0], ConnectionError), err
    finally:
        other.close()
        server.close()


def test_a_daemons_log_names_its_own_packages_classes(tmp_path):
    """A daemon persists what it decoded with the standard pickle, so a
    class in a stored value is named by the package of the daemon that
    wrote the log: after the port's daemon stored a ``TaskSpec``, JAX's
    daemon on that root reads it back as the port's class (importing
    ``repro_torch``), and hands JAX's clients the port's ``TaskSpec``."""
    from repro.core.functions import TaskSpec as JTaskSpec
    from repro_torch.core.functions import TaskSpec

    root, sock = str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}"
    server = KVDServer(root, sock, num_shards=2, fsync="never").start()
    kv = NetKVStore(server.address)
    kv.rpush("q", TaskSpec("t", "j", "fk", "fn", "ik", "rk"))
    kv.close()
    server.close()
    server = JKVDServer(root, sock, num_shards=2, fsync="never").start()
    jkv, kv = JNetKVStore(server.address), NetKVStore(server.address)
    try:
        (got,) = jkv.lrange("q")
        assert type(got) is TaskSpec and type(got) is not JTaskSpec
        assert type(kv.lrange("q")[0]) is TaskSpec
    finally:
        jkv.close()
        kv.close()
        server.close()


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # the call's outcome is the assertion's subject
        return exc
    return None


if __name__ == "__main__":
    role, args = sys.argv[1], sys.argv[2:]
    if role == "engine":
        _engine_main(*args)
    else:
        raise SystemExit(f"unknown role {role!r}")
