"""The runtime example twins of `examples_torch/` (terasort,
featurize_reduce, hogwild_ps, multi_driver, driver_failover, net_cluster)
on the CPU, each held to its JAX example run on the same inputs.

* terasort: per shard count, the same record and intermediate-object
  counts, a global order, and sorted partitions equal to the JAX
  example's byte for byte.
* featurize_reduce: each shard's features equal the JAX example's, bit for
  bit (the labels draw noise from a generator the worker threads share,
  in both, so they follow the threads' order and are not compared); the
  fit's accuracy is at least 0.95.
* hogwild_ps: each config's relative error is below 0.01, over the KV.
* multi_driver, net_cluster: the word counts equal the JAX example's, and
  driver B executed tasks of A's job; net_cluster's daemon is SIGKILLed
  with results still unpublished, and its client reconnects.
* driver_failover: run as a script (the manifest names
  ``__main__._map_fn``); its child dies by SIGKILL, the adopted counts
  equal the JAX example's, and the job's keyspaces are empty after GC.

The JAX examples return nothing, so their outputs are read through the
names their modules use (a store class or a function that records what it
made).
"""

from __future__ import annotations

import ast
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from test_torch_examples import ROOT, SRC, _load  # tests/ is on sys.path

_RUNS = {}


def _recording(cls, made):
    """A subclass of ``cls`` whose instances append themselves to ``made``."""

    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    return Recording


def _capturing(fn, made):
    """``fn`` wrapped to append each result to ``made``."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        made.append(out)
        return out

    return wrapper


def _once(key, run):
    if key not in _RUNS:
        _RUNS[key] = run()
    return _RUNS[key]


def _jax_terasort():
    mod, stores = _load("examples", "terasort"), []
    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "ObjectStore", _recording(mod.ObjectStore, stores))
    try:
        mod.main()
    finally:
        mp.undo()
    out = {}
    for shards in (1, 4, 8):
        store = next(s for s in stores if s.list(f"sorted/{shards}/"))
        out[shards] = {k: store.get_bytes(k) for k in store.list(f"sorted/{shards}/")}
    return out


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_terasort_partitions_equal_the_jax_examples_byte_for_byte(shards):
    twin = _load("examples_torch", "terasort")
    got = _once("terasort", twin.main)[shards]
    want = _once("jax-terasort", _jax_terasort)[shards]
    assert got["n_records"] == 5000 and got["n_intermediate_objects"] == 100
    assert got["sorted_ok"] is True
    assert len(got["parts"]) == twin.N_PARTS and sorted(got["parts"]) == sorted(want)
    for key in want:
        assert got["parts"][key] == want[key], key


def test_featurize_reduce_features_equal_the_jax_examples():
    twin = _load("examples_torch", "featurize_reduce")
    mod, stores = _load("examples", "featurize_reduce"), []
    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "ObjectStore", _recording(mod.ObjectStore, stores))
    try:
        mod.main()
    finally:
        mp.undo()
    got = twin.main()
    assert got["n_images"] == twin.N_SHARDS * twin.PER_SHARD
    assert got["accuracy"] >= 0.95
    assert len(got["features"]) == twin.N_SHARDS
    for i in range(twin.N_SHARDS):
        want_x, _ = stores[0].get(f"feat/{i}")
        got_x, got_y = got["features"][f"feat/{i}"]
        assert got_x.dtype == want_x.dtype and got_x.shape == want_x.shape
        np.testing.assert_array_equal(got_x, want_x)
        assert set(np.unique(got_y)) <= {0.0, 1.0}


@pytest.mark.parametrize("label", ["hogwild (fully async)", "staleness<=4",
                                   "hogwild + int8 grads"])
def test_hogwild_ps_converges_under_each_config(label):
    twin = _load("examples_torch", "hogwild_ps")
    assert [lbl for lbl, _ in twin.PS_CONFIGS] == [
        "hogwild (fully async)", "staleness<=4", "hogwild + int8 grads"]
    row = _once("hogwild", twin.main)[label]
    assert row["rel_err"] < 0.01 and row["kv_ops"] > 0


def _jax_word_counts(name):
    mod, made = _load("examples", name), []
    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "word_count", _capturing(mod.word_count, made))
    mp.chdir(ROOT)  # the JAX net_cluster starts its daemon with PYTHONPATH=src
    try:
        mod.main()
    finally:
        mp.undo()
    assert len(made) == 1
    return made[0]


def test_multi_driver_counts_equal_the_jax_examples():
    twin = _load("examples_torch", "multi_driver")
    got = twin.main()
    assert got["counts"] == _jax_word_counts("multi_driver")
    assert got["counts"]["the"] == 20
    assert got["tasks"]["B"] > 0 and got["tasks"]["A"] + got["tasks"]["B"] >= 20


def test_net_cluster_counts_equal_the_jax_examples_and_the_client_reconnects():
    twin = _load("examples_torch", "net_cluster")
    got = twin.main()
    assert got["counts"] == _jax_word_counts("net_cluster")
    assert got["b_tasks"] > 0
    assert got["done_at_kill"] < twin.N_SQUARES
    assert got["results"] == [x * x for x in range(twin.N_SQUARES)]
    assert got["reconnects"] >= 1


def test_driver_failover_adopts_the_killed_drivers_job_as_the_jax_example_does():
    import repro.core

    made = []
    mp = pytest.MonkeyPatch()
    mp.setattr(repro.core, "adopt_job", _capturing(repro.core.adopt_job, made))
    try:
        _load("examples", "driver_failover").main()
    finally:
        mp.undo()
    assert len(made) == 1
    want = made[0]

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples_torch", "driver_failover.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "[child] map barrier committed for 'failover-demo'; SIGKILL" in lines
    assert "[parent] child driver died (SIGKILL) mid-job" in lines
    assert "[parent] sched/job/ and shuffle/ keyspaces empty after GC" in lines
    counts = dict(ast.literal_eval(next(ln for ln in lines if ln.startswith("[parent] counts "))
                                   [len("[parent] counts "):]))
    assert counts["the"] == 20
    assert counts == want


def test_driver_failover_child_dies_by_sigkill(tmp_path):
    """The child entry alone: it submits, commits the map barrier and dies
    by SIGKILL, leaving the job's manifest behind for an adopter."""
    from repro_torch.storage import FileKVStore

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    kv_root, obj_root = str(tmp_path / "kv"), str(tmp_path / "obj")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples_torch", "driver_failover.py"),
                          "child", kv_root, obj_root], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stdout + out.stderr[-3000:]
    kv = FileKVStore(kv_root, num_shards=2)
    try:
        assert kv.scan("sched/job/failover-demo/")  # the manifest outlives its driver
    finally:
        kv.close()
