"""The port's reprolint and runtime sanitizer (`repro_torch.analysis`)
against the JAX package's (`repro.analysis`), case by case as
`tests/test_reprolint.py` holds the JAX ones, plus parity.

* Lint: each rule's offending and clean snippets, the escape hatch, the
  port's CLI (`tools/reprolint_torch.py`) with its baseline, the port's
  tree linting clean, and the port's ``lint_source`` giving the JAX
  package's findings (rule, line, disabled, reason) on every file of both
  packages.
* Sanitizer: the four detectors on the port's `KVStore`, `ObjectStore` and
  `Scheduler`; one seeded violation of each kind giving the same report
  kinds under both sanitizers; a sanitized handle still pickling by
  reference; the pytest plugin (`-p repro_torch.analysis.pytest_sanitize`)
  and the daemon's CLI under ``REPRO_SANITIZE=1``.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import lint as jlint  # noqa: E402
from repro.analysis import sanitizer as jsan  # noqa: E402
from repro.storage.kv_store import KVStore as JKVStore  # noqa: E402
from repro_torch.analysis import lint, sanitizer  # noqa: E402
from repro_torch.storage import InMemoryBackend, KVStore, ObjectStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_REPO = str(ROOT)
_SRC = os.path.join(_REPO, "src", "repro_torch")
CLI = os.path.join(_REPO, "tools", "reprolint_torch.py")
BASELINE = os.path.join(_REPO, "tools", "reprolint_torch_baseline.json")
PLUGIN = "repro_torch.analysis.pytest_sanitize"
ALL_SOURCES = sorted((ROOT / "src" / "repro").rglob("*.py")) + sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py"))


def _rules(source, path="core/example.py"):
    return sorted({f.rule for f in lint.active(lint.lint_source(source, path))})


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"), **extra)


# ---------------------------------------------------------------------------
# static rules: offending + clean snippet per rule
# ---------------------------------------------------------------------------


def test_fence001_bare_sched_write():
    assert _rules('def f(kv):\n    kv.set("sched/lease/t1", 1)\n') == ["FENCE001"]
    assert _rules('def f(kv):\n    kv.delete("sched/epoch/t1")\n') == ["FENCE001"]
    assert _rules('def f(kv):\n    kv.eval("sched/lease/t1", fn)\n') == []
    assert _rules('def f(kv):\n    kv.incr("sched/epoch/t1", 1)\n') == []
    assert _rules('def f(kv):\n    kv.set("ps/block/0", 1)\n') == []


def test_fence001_blessed_finish_job():
    src = (
        "class Scheduler:\n"
        "    def finish_job(self, job):\n"
        '        self.kv.mdel(["sched/lease/a"])\n'
    )
    # matched by path suffix: the port's scheduler is blessed as JAX's is
    assert _rules(src, path="src/repro_torch/core/scheduler.py") == []
    assert _rules(src, path="src/repro/core/scheduler.py") == []
    assert _rules(src, path="src/repro_torch/core/other.py") == ["FENCE001"]


def test_fence001_job_manifest_keyspace():
    findings = lint.active(
        lint.lint_source('def f(kv):\n    kv.set("sched/job/j1/manifest", 1)\n',
                         "core/example.py")
    )
    assert [f.rule for f in findings] == ["FENCE001"]
    assert "jobs.commit_records" in findings[0].message
    assert _rules('def f(kv):\n    kv.mdel(["sched/job/j1/driver"])\n') == ["FENCE001"]
    assert _rules('def f(kv):\n    kv.eval("sched/job/j1/driver", fn)\n') == []
    assert _rules('def f(kv):\n    kv.eval_many({"sched/job/j1/manifest": fn})\n') == []
    src = (
        "class Scheduler:\n"
        "    def finish_job(self, job):\n"
        '        self.kv.mdel(["sched/job/j1/manifest"])\n'
    )
    assert _rules(src, path="src/repro_torch/core/scheduler.py") == []


def test_batch001_per_key_op_in_loop():
    assert _rules("def f(kv, keys):\n    for k in keys:\n        kv.get(k)\n") == ["BATCH001"]
    assert _rules("def f(kv, keys):\n    vals = kv.mget(keys)\n") == []
    comp = "def f(store, keys):\n    return [store.get(k) for k in keys]\n"
    assert _rules(comp) == ["BATCH001"]


def test_batch001_raw_wire_verbs_in_loop():
    """The port's ``NetClient`` verbs (``call``/``cast``/``call_rid``) are
    covered as JAX's are; ``start_call``/``finish_call`` and ``watch.*``
    are the sanctioned shapes."""
    assert _rules(
        "def f(clients, keys):\n    for c in clients:\n        c.call(\"kv.mget\", keys)\n"
    ) == ["BATCH001"]
    assert _rules(
        "def f(clients, key):\n    for c in clients:\n        c.cast(\"ob.put\", key, b\"x\")\n"
    ) == ["BATCH001"]
    assert _rules(
        "def f(c, keys):\n    return [c.call_rid(\"kv.lpop_n\", k, 1, None) for k in keys]\n"
    ) == ["BATCH001"]
    good = (
        "def f(clients, keys):\n"
        '    hs = [c.start_call("kv.mget", keys) for c in clients]\n'
        "    return [c.finish_call(h) for c, h in zip(clients, hs)]\n"
    )
    assert _rules(good) == []
    assert _rules(
        "def f(c, live):\n    for key in live:\n        c.call(\"watch.kv\", key, True)\n"
    ) == []
    assert _rules('def f(c, op, k):\n    for _ in range(2):\n        c.call(op, k)\n') == []
    assert _rules('def f(c, k):\n    c.call("kv.get", k)\n') == []


def test_fence001_raw_wire_verbs():
    assert _rules('def f(c):\n    c.call("kv.set", "sched/lease/t1", 1)\n') == ["FENCE001"]
    assert _rules('def f(c):\n    c.cast("kv.mdel", ["sched/epoch/t1"])\n') == ["FENCE001"]
    findings = lint.active(
        lint.lint_source('def f(c):\n    c.call("kv.set", "sched/job/j1/manifest", 1)\n',
                         "core/example.py")
    )
    assert [f.rule for f in findings] == ["FENCE001"]
    assert "jobs.commit_records" in findings[0].message
    assert _rules('def f(c):\n    c.call("kv.eval", "sched/lease/t1", fn)\n') == []
    assert _rules('def f(c):\n    c.call("kv.set", "ps/block/0", 1)\n') == []


def test_lock001_blocking_under_lock():
    assert _rules('def f(self, kv):\n    with self._lock:\n        kv.get("k")\n') == ["LOCK001"]
    good = (
        "def f(self, kv):\n"
        "    with self._lock:\n"
        "        x = self.cache\n"
        '    kv.get("k")\n'
    )
    assert _rules(good) == []
    assert _rules("def f(self):\n    with self.cond:\n        self.cond.wait(1.0)\n") == []


def test_event001_sleep_polling_loop():
    bad = "import time\ndef f(done):\n    while not done():\n        time.sleep(0.1)\n"
    assert _rules(bad) == ["EVENT001"]
    ok = (
        "import time\n"
        "class FileWatcher:\n"
        "    def run(self, done):\n"
        "        while not done():\n"
        "            time.sleep(0.1)\n"
    )
    assert _rules(ok) == []


def test_gc001_delete_without_tombstone():
    assert _rules('def gc(kv, keys):\n    kv.mdel(["shuffle/job1/p0"])\n') == ["GC001"]
    good = (
        "def gc(kv, keys):\n"
        '    kv.set("sched/finished/job1", 1)\n'
        '    kv.mdel(["shuffle/job1/p0"])\n'
    )
    assert "GC001" not in _rules(good)


# ---------------------------------------------------------------------------
# escape hatch + baseline
# ---------------------------------------------------------------------------


def test_disable_comment_waives_finding():
    src = (
        "def f(kv, keys):\n"
        "    for k in keys:\n"
        "        # reprolint: disable=BATCH001(demo reason)\n"
        "        kv.get(k)\n"
    )
    findings = lint.lint_source(src, "core/example.py")
    assert lint.active(findings) == []
    waived = [f for f in findings if f.disabled]
    assert [(f.rule, f.disable_reason) for f in waived] == [("BATCH001", "demo reason")]
    assert lint.disabled_counts(findings) == {"BATCH001": 1}
    assert _rules(src.replace("BATCH001", "FENCE001")) == ["BATCH001"]


def test_cli_strict_and_baseline(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("reprolint_torch_cli", CLI)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)

    bad = tmp_path / "bad.py"
    bad.write_text('def f(kv):\n    kv.set("sched/lease/x", 1)\n')
    clean = tmp_path / "clean.py"
    clean.write_text(
        "def f(kv, keys):\n"
        "    # reprolint: disable=BATCH001(test fixture)\n"
        "    vals = [kv.get(k) for k in keys]\n"
    )
    assert cli.main([str(bad), "--strict", "--quiet"]) == 1
    assert cli.main([str(clean), "--strict", "--quiet"]) == 0
    base = tmp_path / "base.json"
    assert cli.main([str(clean), "--baseline", str(base), "--quiet"]) == 1
    assert cli.main([str(clean), "--baseline", str(base), "--update-baseline", "--quiet"]) == 0
    assert json.loads(base.read_text())["disabled_findings"] == {"BATCH001": 1}
    assert cli.main([str(clean), "--baseline", str(base), "--quiet"]) == 0
    grown = tmp_path / "grown.py"
    grown.write_text(
        clean.read_text()
        + "\n\ndef g(kv, keys):\n"
        "    # reprolint: disable=BATCH001(another waiver)\n"
        "    return [kv.get(k) for k in keys]\n"
    )
    assert cli.main([str(grown), "--baseline", str(base), "--quiet"]) == 1
    # with no paths it lints the port's tree, within the port's baseline
    assert cli.main(["--strict", "--baseline", BASELINE, "--quiet"]) == 0


def test_repo_tree_lints_clean():
    """The port's own source stays clean, every waiver carries a reason,
    and the waivers are exactly the port's baseline."""
    findings = lint.lint_tree(_SRC)
    assert lint.active(findings) == [], [f.format() for f in lint.active(findings)]
    for f in findings:
        if f.disabled:
            assert f.disable_reason, f.format()
    with open(BASELINE, encoding="utf-8") as fh:
        assert lint.disabled_counts(findings) == json.load(fh)["disabled_findings"]


def test_seeded_bug_is_caught_end_to_end(tmp_path):
    planted = tmp_path / "seeded.py"
    planted.write_text(
        "def requeue(kv, task_id, spec):\n"
        '    kv.set("sched/lease/" + task_id, spec)\n'
    )
    proc = subprocess.run([sys.executable, CLI, str(planted), "--strict", "--baseline", BASELINE],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert "FENCE001" in proc.stdout


@pytest.mark.parametrize("path", ALL_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_lint_matches_jax_on_every_file(path):
    source = path.read_text(encoding="utf-8")
    rel = str(path.relative_to(ROOT))
    key = lambda f: (f.rule, f.line, f.col, f.disabled, f.disable_reason)  # noqa: E731
    assert [key(f) for f in lint.lint_source(source, rel)] == [
        key(f) for f in jlint.lint_source(source, rel)]


# ---------------------------------------------------------------------------
# runtime sanitizer detectors
# ---------------------------------------------------------------------------


@pytest.fixture
def san_state():
    sanitizer.state.clear()
    yield sanitizer.state
    sanitizer.state.clear()


def _kinds(state):
    return sorted({r.kind for r in state.snapshot()})


def test_sanitizer_unfenced_sched_write(san_state):
    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=2))
    kv.eval("sched/lease/j/t000000-aaaaaaaa", lambda cur: {"epoch": 1})
    assert san_state.snapshot() == []
    kv.set("sched/lease/j/t000000-aaaaaaaa", {"epoch": 2})
    assert _kinds(san_state) == ["unfenced-write"]
    assert san_state.ops_seen == 2


def test_sanitizer_unfenced_job_manifest_write(san_state):
    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=2))
    kv.eval("sched/job/j1/driver", lambda cur: {"owner": "d", "term": 1})
    kv.eval_many({"sched/job/j1/manifest": lambda cur: {"kind": "stage"}})
    assert san_state.snapshot() == []
    kv.set("sched/job/j1/manifest", {"kind": "stage"})
    assert _kinds(san_state) == ["unfenced-write"]
    san_state.clear()
    kv.mdel(["sched/job/j1/stage/0"])
    assert _kinds(san_state) == ["unfenced-write"]
    san_state.clear()
    kv.set("sched/finished/j1", 1.0)
    kv.mdel(["sched/job/j1/stage/0", "sched/job/j1/barrier/0",
             "sched/job/j1/manifest", "sched/job/j1/driver"])
    assert san_state.snapshot() == []


def test_sanitizer_gc_requires_tombstone(san_state):
    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=2))
    kv.mdel(["sched/lease/jobA/t000000-aaaaaaaa"])
    assert _kinds(san_state) == ["unfenced-write"]
    san_state.clear()
    kv.set("sched/finished/jobB", 1.0)
    kv.mdel(["sched/lease/jobB/t000000-bbbbbbbb", "sched/epoch/jobB/t000000-bbbbbbbb"])
    assert san_state.snapshot() == []


def test_sanitizer_blocked_under_lock(san_state):
    """On the port's KVStore, and on an ObjectStore (whose backend is
    instrumented too) under the port's Scheduler's tracked lock."""
    from repro_torch.core.scheduler import Scheduler

    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=1))
    lock = sanitizer.track_lock(threading.Lock(), "test.lock")
    kv.get("k")
    assert san_state.snapshot() == []
    with lock:
        kv.get("k")
    assert _kinds(san_state) == ["blocked-under-lock"]
    san_state.clear()
    store = sanitizer.SanitizingBackend(ObjectStore())
    assert type(store.backend).__name__ == "_SanitizedInMemoryBackend"
    sched = sanitizer.sanitize_scheduler(Scheduler(KVStore(num_shards=1), store))
    assert isinstance(sched._lock, sanitizer.TrackedLock)
    store.put("obj", 1)
    assert san_state.snapshot() == []
    with sched._lock:
        store.backend.exists("obj")
    assert _kinds(san_state) == ["blocked-under-lock"]
    assert "scheduler@" in san_state.snapshot()[0].message


def test_sanitizer_lock_order_inversion(san_state):
    a = sanitizer.track_lock(threading.Lock(), "lock.a")
    b = sanitizer.track_lock(threading.Lock(), "lock.b")
    with a:
        with b:
            pass
    assert san_state.snapshot() == []
    with b:
        with a:
            pass
    assert _kinds(san_state) == ["lock-order"]


def test_sanitizer_torn_read(san_state):
    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=1))
    kv.mset({"pair/x": 1, "pair/y": 1})
    kv.mset({"pair/x": 2, "pair/y": 2})
    assert kv.mget(["pair/x", "pair/y"]) == [2, 2]
    assert san_state.snapshot() == []
    sh = kv._shards[0]
    with sh.lock._inner:
        sh.data["pair/y"] = 1
    kv.mget(["pair/x", "pair/y"])
    assert _kinds(san_state) == ["torn-read"]


def test_sanitizer_preserves_isinstance_and_shard_waits(san_state):
    kv = sanitizer.SanitizingKVStore(KVStore(num_shards=2))
    assert isinstance(kv, KVStore)
    seq = kv.shard_seq("wk")
    t = threading.Timer(0.05, lambda: kv.set("wk", 1))
    t.start()
    try:
        kv.wait_key("wk", seq, timeout_s=5.0)
    finally:
        t.join()
    assert kv.get("wk") == 1
    assert san_state.snapshot() == []


def _seed(kind, san, kv):
    """One seeded violation of ``kind`` on a sanitized ``kv`` of ``san``'s
    package ('clean': none)."""
    if kind == "unfenced-write":
        kv.set("sched/epoch/j/t000001-cccccccc", 3)
    elif kind == "gc-without-tombstone":
        kv.mdel(["sched/attempts/j/t000001-cccccccc"])
    elif kind == "manifest-write":
        kv.mset({"sched/job/j2/manifest": {}, "x": 1})
    elif kind == "blocked-under-lock":
        with san.track_lock(threading.RLock(), "parity.lock"):
            kv.llen("q")
    elif kind == "lock-order":
        a = san.track_lock(threading.Lock(), "parity.a")
        b = san.track_lock(threading.Lock(), "parity.b")
        with a, b:
            pass
        with b, a:
            pass
    elif kind == "torn-read":
        kv.mset({"t/x": 1, "t/y": 1})
        kv.mset({"t/x": 2, "t/y": 2})
        with kv._shards[0].lock._inner:
            kv._shards[0].data["t/x"] = 1
        kv.mget(["t/x", "t/y"])
    else:
        kv.eval("sched/lease/j/t000001-cccccccc", lambda cur: {"epoch": 1})
        kv.mset({"a": 1, "b": 2})
        kv.mget(["a", "b"])


@pytest.mark.parametrize("kind", ["unfenced-write", "gc-without-tombstone", "manifest-write",
                                  "blocked-under-lock", "lock-order", "torn-read", "clean"])
def test_sanitizer_reports_as_jax_does(kind, san_state):
    reports = []
    for san, store_cls in ((jsan, JKVStore), (sanitizer, KVStore)):
        san.state.clear()
        kv = san.SanitizingKVStore(store_cls(num_shards=1))
        _seed(kind, san, kv)
        reports.append(sorted({(r.kind, re.sub(r"batch@\d+", "batch@N", r.message))
                               for r in san.state.snapshot()}))
        san.state.clear()
    assert reports[0] == reports[1]
    expect = {"clean": [], "gc-without-tombstone": ["unfenced-write"],
              "manifest-write": ["unfenced-write"]}.get(kind, [kind])
    assert sorted({k for k, _ in reports[1]}) == expect


def test_a_sanitized_handle_pickles_by_reference(tmp_path, san_state):
    """A sanitized store still pickles as an endpoint (registry id and
    reconnect spec): the swapped-in ``_Sanitized*`` class, which has no JAX
    twin on the shared wire, is named nowhere in its bytes."""
    from repro_torch.storage import FileBackend, FileKVStore
    from repro_torch.storage.net_kv import _wire_dumps, _wire_loads

    kv = sanitizer.SanitizingKVStore(FileKVStore(str(tmp_path / "kv"), fsync="never"))
    store = sanitizer.SanitizingBackend(ObjectStore(backend=FileBackend(str(tmp_path / "obj"))))
    mem = sanitizer.SanitizingBackend(InMemoryBackend())
    try:
        for handle in (kv, store):
            assert type(handle).__name__.startswith("_Sanitized")
            assert "_Sanitized" not in repr(handle._endpoint_spec())
            for blob, loads in ((pickle.dumps(handle), pickle.loads),
                                (_wire_dumps(handle), _wire_loads)):
                assert b"_Sanitized" not in blob
                assert loads(blob) is handle
        assert type(mem).__name__ == "_SanitizedInMemoryBackend"
    finally:
        kv.close()
    assert san_state.snapshot() == []


# ---------------------------------------------------------------------------
# the pytest plugin and the daemon's CLI under REPRO_SANITIZE=1
# ---------------------------------------------------------------------------


def test_the_plugin_fails_a_test_that_leaves_a_report(tmp_path):
    (tmp_path / "test_planted.py").write_text(
        "from repro_torch.storage import KVStore\n\n"
        "def test_planted_unfenced_write():\n"
        "    kv = KVStore(num_shards=1)\n"
        "    kv.set('sched/lease/j/t000000-aaaaaaaa', {'epoch': 1})\n\n"
        "def test_fenced_write():\n"
        "    kv = KVStore(num_shards=1)\n"
        "    kv.eval('sched/lease/j/t000000-aaaaaaaa', lambda cur: {'epoch': 1})\n"
    )
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", PLUGIN,
           "--rootdir", str(tmp_path), str(tmp_path / "test_planted.py")]
    on = subprocess.run(cmd, cwd=tmp_path, env=_env(REPRO_SANITIZE="1"),
                        capture_output=True, text=True, timeout=120)
    assert on.returncode == 1, on.stdout + on.stderr
    assert "2 passed, 1 error" in on.stdout, on.stdout  # the report fails the teardown
    assert "[unfenced-write]" in on.stdout and "sched/lease/j/t000000-aaaaaaaa" in on.stdout
    env = _env()
    env.pop("REPRO_SANITIZE", None)
    off = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert off.returncode == 0 and "2 passed" in off.stdout, off.stdout  # the plugin is idle


def test_the_wire_protocol_suite_passes_sanitized():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", PLUGIN, "tests/test_torch_net_protocol.py"],
        cwd=_REPO, env=_env(REPRO_SANITIZE="1", JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert " passed" in proc.stdout and "error" not in proc.stdout.splitlines()[-1]


def test_the_daemons_cli_installs_the_ports_sanitizer(tmp_path):
    sock = str(tmp_path / "kvd.sock")
    code = (
        "import gc, os, sys, threading, time\n"
        "from repro_torch.storage import NetKVStore, net_server\n"
        f"args = ['--root', {str(tmp_path / 'kvd')!r}, '--uds', {sock!r}, '--fsync', 'never']\n"
        "threading.Thread(target=net_server.main, args=(args,), daemon=True).start()\n"
        "deadline = time.monotonic() + 30\n"
        f"while not os.path.exists({sock!r}) and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        f"kv = NetKVStore('unix:' + {sock!r})\n"
        "kv.set('k', [1]); assert kv.get('k') == [1]\n"
        "from repro_torch.analysis import sanitizer\n"
        "server = next(o for o in gc.get_objects() if isinstance(o, net_server.KVDServer))\n"
        "held = [type(v).__name__ for v in vars(server).values()\n"
        "        if type(v).__name__.startswith('_Sanitized')]\n"
        "print(sanitizer._installed, sorted(held), type(kv).__name__,\n"
        "      sanitizer.state.ops_seen > 0, len(sanitizer.state.snapshot()),\n"
        "      'torch' in sys.modules, sorted(m for m in sys.modules\n"
        "                                     if m.split('.')[0] in ('jax', 'repro')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(REPRO_SANITIZE="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the daemon's stores and this process's client are instrumented, no
    # report, and the sanitized daemon still loads neither torch nor JAX
    assert proc.stdout.strip().splitlines()[-1] == (
        "True ['_SanitizedFileKVStore'] _SanitizedNetKVStore True 0 False []"), proc.stdout
