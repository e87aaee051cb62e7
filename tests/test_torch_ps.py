"""The port's parameter server (`repro_torch.core.ps`) against the JAX
package's, on the CPU: HOGWILD! with one worker ends on JAX's parameters,
the int8 path rounds bit for bit as JAX's for the same generator, a pull is
one batched ``mget``, a push lands every block before its version, the
staleness bound rejects, and `tests/test_system.py`'s word count + PS
pipeline runs on the port.  A ``grad_fn`` must pickle by reference: a
nested one raises the port's ``TypeError``.  Over the port's ``repro-kvd``
daemon (in this process) the update functions run server-side: pushes
stay bit-equal to JAX's lambdas in memory on every store, and HOGWILD!'s
three configurations end on JAX's in-memory parameters."""

import threading
import time
from functools import partial

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import ParameterServer as JParameterServer  # noqa: E402
from repro.core import PSConfig as JPSConfig  # noqa: E402
from repro.core import WrenExecutor as JWrenExecutor  # noqa: E402
from repro.core import hogwild_sgd as jhogwild_sgd  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.storage import KVStore as JKVStore  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ParameterServer,
    PSConfig,
    WrenExecutor,
    hogwild_sgd,
    word_count,
)
from repro_torch.core import ps  # noqa: E402
from repro_torch.data import make_documents  # noqa: E402
from repro_torch.storage import FileKVStore, KVStore, NetBackend, NetKVStore, ObjectStore  # noqa: E402
from repro_torch.storage.net_server import KVDServer  # noqa: E402


def _lsq_grad(w, shard):
    X, y = shard
    return 2.0 * X.T @ (X @ w - y) / len(y)


def _shards(n, seed=0, dim=16, rows=32):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=dim)
    out = []
    for _ in range(n):
        X = rng.normal(size=(rows, dim))
        out.append((X, X @ w_true + 0.01 * rng.normal(size=rows)))
    return w_true, out


@pytest.mark.parametrize("num_blocks,max_staleness", [(4, None), (3, 2)])
def test_one_worker_without_compression_ends_on_jax_parameters(num_blocks, max_staleness):
    """One worker is sequential, so both packages take the same steps: the
    final parameters within 1e-6."""
    w_true, shards = _shards(1)
    out = []
    for Exec, PS, Cfg, KV, run in (
        (WrenExecutor, ParameterServer, PSConfig, KVStore, hogwild_sgd),
        (JWrenExecutor, JParameterServer, JPSConfig, JKVStore, jhogwild_sgd),
    ):
        with Exec(num_workers=1) as wex:
            server = PS(KV(num_shards=4), np.zeros(16), Cfg(num_blocks=num_blocks,
                                                           max_staleness=max_staleness))
            out.append(run(wex, server, _lsq_grad, shards, steps_per_worker=30, lr=0.01))
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-6)
    assert np.linalg.norm(out[0] - w_true) < np.linalg.norm(w_true)  # it learned


def test_int8_path_bit_equal_for_the_same_rng():
    rng = np.random.default_rng(5)
    delta = rng.normal(size=40).astype(np.float32)
    q, scale = ps._quantize_int8(delta, np.random.default_rng(3))
    jq, jscale = jps._quantize_int8(delta, np.random.default_rng(3))
    assert q.dtype == jq.dtype == np.int8 and np.array_equal(q, jq) and scale == jscale
    params = []
    for PS, Cfg, KV in ((ParameterServer, PSConfig, KVStore), (JParameterServer, JPSConfig, JKVStore)):
        server = PS(KV(num_shards=2), np.zeros(40, np.float32), Cfg(num_blocks=4, compress_int8=True))
        assert server.push_delta(delta, rng=np.random.default_rng(3)) == 4
        assert server.push_delta(-0.5 * delta, rng=np.random.default_rng(4)) == 4
        params.append(server.current())
    assert params[0].dtype == params[1].dtype and np.array_equal(params[0], params[1])


def test_pull_is_one_batched_mget():
    kv = KVStore(num_shards=4)
    server = ParameterServer(kv, np.zeros(64, np.float32), PSConfig(num_blocks=8))
    kv.ledger.clear()
    params, vers = server.pull(worker="puller")
    assert params.shape == (64,) and vers == [0] * 8
    ops = [r.op for r in kv.ledger.records() if r.worker == "puller"]
    assert set(ops) == {"mget"} and len(ops) <= 4  # one round-trip per shard, never per key


def test_push_is_batched_and_lands_data_before_versions():
    kv = KVStore(num_shards=4)
    server = ParameterServer(kv, np.zeros(64, np.float32), PSConfig(num_blocks=8))
    kv.ledger.clear()
    assert server.push_delta(np.ones(64, np.float32), worker="pusher") == 8
    mevals = [r for r in kv.ledger.records() if r.worker == "pusher"]
    assert {r.op for r in mevals} == {"meval"} and 2 <= len(mevals) <= 2 * 4
    half = len(mevals) // 2  # block data (float arrays) first, then the version counters
    assert sum(r.nbytes for r in mevals[:half]) > sum(r.nbytes for r in mevals[half:])
    params, vers = server.pull()
    np.testing.assert_allclose(params, np.ones(64, np.float32))
    assert vers == [1] * 8


def test_staleness_bound_rejects_and_wait_fresh_wakes():
    kv = KVStore(num_shards=2)
    server = ParameterServer(kv, np.zeros(8, np.float32), PSConfig(num_blocks=2, max_staleness=0))
    assert server.push_delta(np.ones(8, np.float32), pulled_versions=[0, 0]) == 2
    assert server.push_delta(np.ones(8, np.float32), pulled_versions=[-1, -1]) == 0
    params, vers = server.pull()
    np.testing.assert_allclose(params, np.ones(8, np.float32))
    assert vers == [1, 1]

    def pusher():
        time.sleep(0.05)
        server.push_delta(np.ones(8, np.float32), pulled_versions=[1, 1])

    t = threading.Thread(target=pusher)
    t.start()
    t0 = time.monotonic()
    ver = server.wait_fresh(1, seen_version=1, timeout_s=5.0)
    t.join()
    assert ver >= 2 and time.monotonic() - t0 < 1.0  # woken by the push


def test_nested_grad_fn_raises_the_ports_type_error():
    _, shards = _shards(2)

    def nested(w, shard):
        return _lsq_grad(w, shard)

    with WrenExecutor(num_workers=1) as wex:
        server = ParameterServer(wex.kv, np.zeros(16), PSConfig(num_blocks=2))
        with pytest.raises(TypeError, match="pickle"):
            hogwild_sgd(wex, server, nested, shards, steps_per_worker=1)
        # a partial of a module-level function ships
        w = hogwild_sgd(wex, server, partial(_lsq_grad), shards, steps_per_worker=2, lr=0.01)
        assert w.shape == (16,) and np.isfinite(w).all()


def test_full_pipeline_wordcount_and_ps():
    """`tests/test_system.py::test_full_pipeline_wordcount_and_ps` on the
    port: word count, then least squares by HOGWILD! on the same runtime."""
    with WrenExecutor(num_workers=4) as wex:
        docs = make_documents(6, 4, seed=2)
        wc = word_count(wex, docs, num_reducers=2)
        assert sum(wc.values()) == sum(len(l.split()) for d in docs for l in d)
        rng = np.random.default_rng(0)
        true_w = rng.normal(size=8)
        shards = []
        for _ in range(4):
            X = rng.normal(size=(16, 8))
            shards.append((X, X @ true_w))
        server = ParameterServer(wex.kv, np.zeros(8), PSConfig(num_blocks=2))
        w = hogwild_sgd(wex, server, _lsq_grad, shards, steps_per_worker=40, lr=0.02)
        assert np.linalg.norm(w - true_w) < 0.2


@pytest.fixture
def daemon(tmp_path):
    server = KVDServer(str(tmp_path / "kvd"), f"unix:{tmp_path / 'kvd.sock'}", num_shards=4,
                       fsync="never").start()
    yield server
    server.close()


@pytest.mark.parametrize("kind", ["memory", "file", "net"])
@pytest.mark.parametrize("int8", [False, True])
def test_pushes_bit_equal_to_jax_lambdas_on_every_store(tmp_path, daemon, kind, int8):
    """``push_delta``'s update functions (standard-library partials in the
    port, lambdas in JAX) give the same bits in memory, on file roots and
    run by the daemon."""
    rng = np.random.default_rng(5)
    delta = rng.normal(size=40).astype(np.float32)
    kv = {"memory": lambda: KVStore(num_shards=2),
          "file": lambda: FileKVStore(str(tmp_path / "kv"), num_shards=2, fsync="never"),
          "net": lambda: NetKVStore(daemon.address)}[kind]()
    params = []
    for PS, Cfg, store in ((ParameterServer, PSConfig, kv), (JParameterServer, JPSConfig, JKVStore(num_shards=2))):
        server = PS(store, np.zeros(40), Cfg(num_blocks=4, compress_int8=int8))
        assert server.push_delta(delta, rng=np.random.default_rng(3)) == 4
        assert server.push_delta(-0.5 * delta, rng=np.random.default_rng(4)) == 4
        params.append(server.pull())
    assert params[0][0].dtype == params[1][0].dtype and np.array_equal(params[0][0], params[1][0])
    assert params[0][1] == params[1][1] == [2] * 4
    if kind != "memory":
        kv.close()


@pytest.mark.parametrize("cfg", [dict(num_blocks=4), dict(num_blocks=3, max_staleness=2),
                                 dict(num_blocks=4, compress_int8=True)],
                         ids=["hogwild", "staleness<=2", "int8"])
def test_hogwild_over_the_ports_daemon_ends_on_jax_in_memory_parameters(daemon, cfg):
    """The runtime and the parameter server both on the daemon, one worker
    (sequential, so both packages take the same steps): within 1e-6 of
    JAX's in-memory run."""
    w_true, shards = _shards(1)
    kv = NetKVStore(daemon.address)
    store = ObjectStore(backend=NetBackend(daemon.address))
    try:
        with WrenExecutor(store=store, kv=kv, num_workers=1) as wex:
            server = ParameterServer(kv, np.zeros(16), PSConfig(**cfg))
            w = hogwild_sgd(wex, server, _lsq_grad, shards, steps_per_worker=30, lr=0.01)
    finally:
        kv.close()
        store.backend.close()
    with JWrenExecutor(num_workers=1) as jwex:
        jserver = JParameterServer(JKVStore(num_shards=4), np.zeros(16), JPSConfig(**cfg))
        jw = jhogwild_sgd(jwex, jserver, _lsq_grad, shards, steps_per_worker=30, lr=0.01)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)
    assert np.linalg.norm(w - w_true) < np.linalg.norm(w_true)
