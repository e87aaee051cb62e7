"""The port's runtime (`repro_torch.core`) and the storage verbs it calls,
on the CPU: ``map``/``get_all`` of module-level functions, a lambda refused
with a ``TypeError`` (callables ship with the standard ``pickle``), the
elastic chunk pickled with the standard library, failures and a worker's
death through the copied scheduler, and the object/KV/serialization verbs,
the KV verbs on both packages' in-memory stores."""

import functools
import operator
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.storage import DELETE as JDELETE  # noqa: E402
from repro.storage import KVStore as JKVStore  # noqa: E402
from repro.storage import ObjectStore as JObjectStore  # noqa: E402
from repro.storage import serialization as jser  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FunctionSpec,
    ResultFuture,
    TaskSpec,
    WrenExecutor,
    get_all,
    stage_input,
)
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.storage import DELETE, KVStore, ObjectStore  # noqa: E402
from repro_torch.storage import serialization as tser  # noqa: E402
from repro_torch.train import adamw, cosine_schedule  # noqa: E402
from repro_torch.train import elastic as tel  # noqa: E402


def square(x):
    return x * x


def fails_on_three(x):
    if x == 3:
        raise ValueError("three")
    return x


@pytest.fixture
def wex():
    ex = WrenExecutor(num_workers=3)
    yield ex
    ex.shutdown()


def test_map_and_get_all_of_module_level_functions(wex):
    assert get_all(wex.map(square, list(range(20)))) == [x * x for x in range(20)]
    assert get_all(wex.map(functools.partial(operator.add, 5), [1, 2])) == [6, 7]


def test_mapping_a_lambda_raises_type_error_that_says_why(wex):
    with pytest.raises(TypeError, match="standard library.*import path"):
        wex.map(lambda x: x, [1])
    def nested(x):
        return x
    with pytest.raises(TypeError, match="lambda or nested function"):
        wex.map(nested, [1])


def test_a_failing_task_publishes_its_traceback(wex):
    [ok, fut] = wex.map(fails_on_three, [1, 3])
    assert ok.result(timeout_s=30) == 1
    # failures are published per attempt (retries may still run), so the
    # error objects are read, as the JAX package's runtime test reads them
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not fut.errors():
        time.sleep(0.01)
    errs = fut.errors()
    assert errs and "ValueError: three" in errs[0].error


def test_worker_death_recovers_via_lease_expiry():
    ex = WrenExecutor(num_workers=0, seed=3)
    try:
        func = FunctionSpec.register(ex.store, square, worker="driver")
        tasks = [TaskSpec.make("ft", func, stage_input(ex.store, "ft", v), i)
                 for i, v in enumerate([1, 2, 3])]
        ex.pool.fault_plan.die_before_publish_tasks.add(tasks[0].task_id)
        ex.scheduler.submit_many(tasks)
        ex.scale_to(3)
        futs = [ResultFuture(ex.store, t) for t in tasks]
        assert get_all(futs, timeout_s=60) == [1, 4, 9]
        assert ex.scheduler.attempts(tasks[0]) >= 2  # the killed task ran again
    finally:
        ex.shutdown()


def test_elastic_chunk_pickles_with_the_standard_library():
    cfg = CONFIGS["llama3-8b"].reduced()
    store = ObjectStore()
    chunk = tel.make_chunk_fn(
        cfg, adamw(cosine_schedule(1e-3, 1, 10), quantize_moments=True), store,
        tel.ElasticTrainConfig(run="p"),
        functools.partial(synthetic_batch, DataConfig(8, 2, cfg.vocab_size), cfg=cfg), "cpu",
    )
    back = pickle.loads(pickle.dumps(chunk))
    assert back.store is store  # store handles pickle by reference
    assert back.cfg == cfg and back.device == torch.device("cpu")
    assert back.opt.quantize_moments and back.opt.sched.total == 10
    assert all(not isinstance(v, torch.Tensor) for v in vars(back).values())


def test_object_store_runtime_verbs():
    s = ObjectStore()
    k1 = s.put_content_addressed("input/j", [1, 2, 3])
    assert s.put_content_addressed("input/j", [1, 2, 3]) == k1  # content-addressed, idempotent
    assert s.publish_result("result/a", {"v": 1})
    assert not s.publish_result("result/a", {"v": 2})  # first writer wins
    assert s.get("result/a") == {"v": 1}
    s.put_many({f"job/x/{i}": i for i in range(5)})
    assert s.delete_prefix("job/x/") == 5 and s.list("job/x/") == []
    s.delete_many([k1])
    assert not s.exists_many([k1]) and s.watch_tick_s() is None and s.watch_tick_s(0.1) == 0.1
    s.wait_keys(["result/a"], timeout_s=1)
    with pytest.raises(TimeoutError):
        s.wait_keys(["absent"], timeout_s=0.05)


def test_content_keys_match_the_jax_package():
    for value in ([1, 2, 3], {"a": "b"}):
        assert tser.dumps_with_key("p", value)[0] == jser.dumps_with_key("p", value)[0]
    assert ObjectStore().put_content_addressed("p", 7) == JObjectStore().put_content_addressed("p", 7)


def _bump(cur):
    return (cur or 0) + 1


def _drop(sentinel, cur):
    return sentinel


@pytest.mark.parametrize("cls,delete", [(KVStore, DELETE), (JKVStore, JDELETE)], ids=["port", "jax"])
def test_kv_verbs_the_runtime_calls(cls, delete):
    kv = cls(num_shards=3)
    kv.set("a", 1)
    assert kv.incr("a", 2) == 3 and kv.get("a") == 3
    assert kv.setnx("b", "x") and not kv.setnx("b", "y")
    kv.mset({"c": 1, "d": 2, "e": 3})
    assert kv.mget(["c", "d", "e"]) == [1, 2, 3]
    assert kv.mdel(["c", "d", "zz"]) == 2
    assert kv.eval("n", _bump) == 1 and kv.eval("n", _bump) == 2
    assert kv.eval("n", functools.partial(_drop, delete)) is None and kv.get("n") is None
    seq = kv.shard_seq("w")
    kv.notify_key("w")
    assert kv.wait_key("w", seq, 0.5) > seq  # a virtual touch wakes watchers
    kv.rpush("q", 1, 2, 3)
    assert kv.lpop_n("q", 1) == [1] and kv.llen("q") == 2


def test_tensor_trees_serialize_without_pickle():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.tensor([1.5, -2.0], dtype=torch.bfloat16), "i": [np.arange(3)]}
    blob = tser.dumps(tree)
    assert blob[4] == 3  # the raw codec, not pickle
    back = tser.loads(blob)
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], tree["h"])
    np.testing.assert_array_equal(back["w"], tree["w"].numpy())
    np.testing.assert_array_equal(back["i"][0], np.arange(3))
    # a value that is not an array tree takes the pickle codec, as in JAX
    assert tser.dumps({"a": [1, "x"]}) == jser.dumps({"a": [1, "x"]})
