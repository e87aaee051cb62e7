"""Runtime sanitizer: interpose on every KV/store op and check, live, the
invariants ``reprolint`` can only approximate statically (a copy of
`repro.analysis.sanitizer` over the port's stores and scheduler: the same
detectors, caps and in-place class swap).

Four detectors:

  * **unfenced-write** — a bare ``set``/``mset`` on ``sched/lease/`` or
    ``sched/epoch/`` (lease records install only through epoch-compared
    ``eval``; epochs only move through ``incr``), or a ``delete``/``mdel``
    of lease/epoch/attempt keys for a job whose ``sched/finished/``
    tombstone this process has not written — i.e. GC-order violations a
    zombie could exploit;
  * **lock-order** — a cycle in the acquired-lock graph over the tracked
    locks (KV shard locks, the scheduler handle lock);
  * **blocked-under-lock** — any KV/store round-trip *entered* while the
    calling thread already holds a tracked lock (the lexical LOCK001 rule,
    enforced dynamically and interprocedurally);
  * **torn-read** — a reader's ``mget`` observes, within one shard, part
    of a multi-key ``mset``/``eval_many`` batch applied and part not:
    per-shard batch atomicity (the contract every fenced transition leans
    on) was violated.

Wrapping is an in-place ``__class__`` swap to a generated subclass, so
``isinstance`` checks (``shuffle`` dispatches on ``KVStore``) and the
``_Endpoint`` by-reference pickling both keep working::

    kv = SanitizingKVStore(KVStore())        # same object, instrumented
    store = SanitizingBackend(ObjectStore()) # ditto (wraps backend too)

``install()`` hooks the constructors of every built-in KV/store/backend
class plus ``Scheduler`` so an *existing test suite* runs fully sanitized
without edits; the pytest plugin :mod:`.pytest_sanitize` (``-p
repro_torch.analysis.pytest_sanitize``) calls it when ``REPRO_SANITIZE=1``
and fails any test that produced reports; the ``repro-kvd`` daemon's CLI
calls it too.  Sanitizer bookkeeping never touches the op ledgers, so
round-trip-count assertions are unaffected.  ``state.ops_seen`` counts the
operations interposed since the last ``clear()``.
"""

from __future__ import annotations

import pickle
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

_SCHED_LEASE = "sched/lease/"
_SCHED_EPOCH = "sched/epoch/"
_SCHED_ATTEMPTS = "sched/attempts/"
_SCHED_FINISHED = "sched/finished/"
_SCHED_JOB = "sched/job/"  # job-manifest keyspace (core/jobs.py)

# Values bigger than this are not digested for torn-read tracking (the
# check degrades to "unknown", which never reports): keeps soak tests fast.
_DIGEST_CAP_BYTES = 1 << 20
_SHADOW_HISTORY = 8
_MAX_REPORTS = 64
_OPLOG_LEN = 512


@dataclass
class Report:
    kind: str  # unfenced-write | lock-order | blocked-under-lock | torn-read
    message: str
    thread: str

    def __str__(self) -> str:
        return f"[{self.kind}] ({self.thread}) {self.message}"


@dataclass
class OpEvent:
    """One interposed operation: the ``(thread, locks-held, key, op,
    epoch-if-sched)`` tuple the sanitizer records for every op."""
    thread: str
    locks: Tuple[str, ...]
    op: str
    key: str
    epoch: Optional[int] = None


class _TLS(threading.local):
    def __init__(self) -> None:
        self.held: List[Tuple[int, str]] = []  # (lock id, lock name)
        self.depth = 0


class SanitizerState:
    def __init__(self) -> None:
        self.enabled = False
        self._mu = threading.Lock()
        self.reports: List[Report] = []
        self._seen_msgs: Set[str] = set()
        self.oplog: List[OpEvent] = []
        self._tls = _TLS()
        # acquired-lock graph: edges held-lock-id -> acquired-lock-id
        self._edges: Dict[int, Set[int]] = {}
        self._lock_names: Dict[int, str] = {}
        self._stamp = 0
        self.ops_seen = 0

    # -- reports ---------------------------------------------------------
    def report(self, kind: str, message: str) -> None:
        t = threading.current_thread().name
        with self._mu:
            if message in self._seen_msgs or len(self.reports) >= _MAX_REPORTS:
                return
            self._seen_msgs.add(message)
            self.reports.append(Report(kind, message, t))

    def snapshot(self) -> List[Report]:
        with self._mu:
            return list(self.reports)

    def clear(self) -> None:
        with self._mu:
            self.reports.clear()
            self._seen_msgs.clear()
            self.oplog.clear()
            self.ops_seen = 0

    # -- op log ----------------------------------------------------------
    def log_op(self, op: str, key: str, epoch: Optional[int]) -> None:
        ev = OpEvent(
            thread=threading.current_thread().name,
            locks=tuple(n for _i, n in self._tls.held),
            op=op,
            key=key,
            epoch=epoch,
        )
        with self._mu:
            self.ops_seen += 1
            self.oplog.append(ev)
            if len(self.oplog) > _OPLOG_LEN:
                del self.oplog[: len(self.oplog) - _OPLOG_LEN]

    # -- lock tracking ---------------------------------------------------
    def note_acquire(self, lock_id: int, name: str) -> None:
        held = self._tls.held
        with self._mu:
            self._lock_names[lock_id] = name
            for hid, _hname in held:
                if hid == lock_id:
                    continue  # re-entrant acquire, no edge
                self._edges.setdefault(hid, set()).add(lock_id)
                if self._reachable(lock_id, hid):
                    self.reports_unlocked_lock_order(hid, lock_id)
        held.append((lock_id, name))

    def reports_unlocked_lock_order(self, hid: int, lock_id: int) -> None:
        # caller holds self._mu
        msg = (
            f"lock-order inversion: {self._lock_names.get(hid, hid)} -> "
            f"{self._lock_names.get(lock_id, lock_id)} closes a cycle in "
            f"the acquired-lock graph"
        )
        if msg not in self._seen_msgs and len(self.reports) < _MAX_REPORTS:
            self._seen_msgs.add(msg)
            self.reports.append(
                Report("lock-order", msg, threading.current_thread().name)
            )

    def _reachable(self, src: int, dst: int) -> bool:
        # caller holds self._mu
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def note_release(self, lock_id: int, all_counts: bool = False) -> None:
        held = self._tls.held
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lock_id:
                del held[i]
                if not all_counts:
                    return

    def held_locks(self) -> List[str]:
        return [n for _i, n in self._tls.held]

    def next_stamp(self) -> int:
        with self._mu:
            self._stamp += 1
            return self._stamp


state = SanitizerState()


# ---------------------------------------------------------------------------
# tracked locks
# ---------------------------------------------------------------------------

class TrackedLock:
    """Proxy over a ``threading.Lock``/``RLock`` that records per-thread
    holds and feeds the acquired-lock graph.  Implements the private
    ``Condition`` hooks so a ``threading.Condition`` built over it keeps
    working — and so ``Condition.wait`` correctly *untracks* the lock for
    the duration of the wait (waiting on a condition releases its lock;
    that is the sanctioned blocking-under-lock idiom)."""

    def __init__(self, inner: Any, name: str) -> None:
        self._inner = inner
        self._name = name

    # -- plain lock protocol --------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            state.note_acquire(id(self), self._name)
        return got

    def release(self) -> None:
        state.note_release(id(self))
        self._inner.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ------------------------------------------
    def _release_save(self) -> Tuple[str, Any]:
        # An RLock fully releases (all recursion levels); mirror that in
        # the tracking so a waiting thread shows no held lock.
        state.note_release(id(self), all_counts=True)
        if hasattr(self._inner, "_release_save"):
            return ("rlock", self._inner._release_save())
        self._inner.release()
        return ("lock", None)

    def _acquire_restore(self, saved: Tuple[str, Any]) -> None:
        kind, inner_state = saved
        if kind == "rlock":
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        state.note_acquire(id(self), self._name)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name}>"


def track_lock(lock: Any, name: str) -> TrackedLock:
    """Wrap an arbitrary lock so the sanitizer sees its holds."""
    return TrackedLock(lock, name)


# ---------------------------------------------------------------------------
# value digests (torn-read shadow store)
# ---------------------------------------------------------------------------

_DELETED = "<deleted>"


def _digest(value: Any) -> Optional[int]:
    """Cheap content digest, or None when the value can't participate in
    torn-read tracking (unpicklable / too large)."""
    try:
        if isinstance(value, (bytes, bytearray)):
            blob = bytes(value)
        else:
            blob = pickle.dumps(value, protocol=4)
    except Exception:
        return None
    if len(blob) > _DIGEST_CAP_BYTES:
        return None
    return zlib.crc32(blob)


class _KvShadow:
    """Per-KV-instance write-provenance: key -> recent (stamp, digest)
    history, plus the multi-key batches whose per-shard atomicity the
    reader-side check verifies.  All mutation happens under one mutex, so
    a reader either sees a batch fully recorded or not at all (not-at-all
    degrades to 'unknown', which never reports)."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.hist: Dict[str, List[Tuple[int, Optional[int]]]] = {}
        # batch stamp -> {key: shard}; only batches with >=2 keys in some
        # shard are interesting, but recording all is simpler and cheap.
        self.batches: Dict[int, Dict[str, int]] = {}

    def record_batch(self, stamped: Dict[str, Tuple[int, Any]], shards: Dict[str, int]) -> None:
        with self.mu:
            for key, (stamp, value) in stamped.items():
                h = self.hist.setdefault(key, [])
                h.append((stamp, _digest(value)))
                if len(h) > _SHADOW_HISTORY:
                    del h[: len(h) - _SHADOW_HISTORY]
            if stamped:
                stamp = next(iter(stamped.values()))[0]
                self.batches[stamp] = dict(shards)
                if len(self.batches) > 256:
                    for s in sorted(self.batches)[: len(self.batches) - 256]:
                        self.batches.pop(s, None)

    def record_single(self, key: str, value: Any, stamp: int) -> None:
        with self.mu:
            if key not in self.hist:
                return  # only batch-touched keys are tracked
            h = self.hist[key]
            h.append((stamp, _digest(value)))
            if len(h) > _SHADOW_HISTORY:
                del h[: len(h) - _SHADOW_HISTORY]

    def invalidate(self, key: str) -> None:
        with self.mu:
            self.hist.pop(key, None)

    def check_read(self, keys: List[str], values: List[Any], shard_of: Callable[[str], int]) -> Optional[str]:
        """Classify each observed value against the shadow history; report
        a batch whose same-shard keys straddle 'applied' and 'pre-batch'."""
        with self.mu:
            if not self.batches:
                return None
            observed: Dict[str, Optional[int]] = {}
            for k, v in zip(keys, values):
                if k in self.hist:
                    observed[k] = _digest(v)
            for stamp, members in self.batches.items():
                group = [k for k in observed if k in members]
                if len(group) < 2:
                    continue
                by_shard: Dict[int, List[str]] = {}
                for k in group:
                    by_shard.setdefault(shard_of(k), []).append(k)
                for shard, g in by_shard.items():
                    if len(g) < 2:
                        continue
                    applied, stale = [], []
                    for k in g:
                        dig = observed[k]
                        stamps = [s for s, d in self.hist.get(k, []) if d == dig and d is not None]
                        if not stamps:
                            continue  # unknown provenance: never report
                        if max(stamps) >= stamp:
                            applied.append(k)
                        else:
                            stale.append(k)
                    if applied and stale:
                        return (
                            f"torn read: batch@{stamp} on shard {shard} — "
                            f"{applied[0]!r} observed applied but {stale[0]!r} "
                            f"observed pre-batch (per-shard batch atomicity broken)"
                        )
        return None


def _shadow(kv: Any) -> _KvShadow:
    sh = kv.__dict__.get("_san_shadow")
    if sh is None:
        sh = kv.__dict__["_san_shadow"] = _KvShadow()
    return sh


def _finished_mirror(kv: Any) -> Set[str]:
    m = kv.__dict__.get("_san_finished")
    if m is None:
        m = kv.__dict__["_san_finished"] = set()
    return m


# ---------------------------------------------------------------------------
# op interposition
# ---------------------------------------------------------------------------

def _first_key(args: tuple) -> str:
    return args[0] if args and isinstance(args[0], str) else "?"


def _keys_of(op: str, args: tuple) -> List[str]:
    if not args:
        return []
    a0 = args[0]
    if op in ("mget", "mdel") and isinstance(a0, (list, tuple)):
        return [k for k in a0 if isinstance(k, str)]
    if op in ("mset", "eval_many", "rpush_many") and isinstance(a0, dict):
        return [k for k in a0 if isinstance(k, str)]
    if isinstance(a0, str):
        return [a0]
    return []


def _epoch_of(keys: List[str], value: Any) -> Optional[int]:
    if not any(k.startswith((_SCHED_LEASE, _SCHED_EPOCH)) for k in keys):
        return None
    if isinstance(value, dict) and "epoch" in value:
        try:
            return int(value["epoch"])
        except Exception:
            return None
    if isinstance(value, int):
        return value
    return None


def _job_of_task_key(key: str) -> str:
    # manifest keys are "sched/job/<job_id>/{manifest,driver,stage/i,...}" —
    # the job id is the FIRST path segment, unlike task keys below where a
    # job id may itself contain '/' (stage jobs like "mr-x/s0") and the
    # task suffix is the LAST segment.
    if key.startswith(_SCHED_JOB):
        return key[len(_SCHED_JOB):].split("/", 1)[0]
    # task keys are "<prefix><job_id>/t<idx>-<hash>"
    for p in (_SCHED_LEASE, _SCHED_EPOCH, _SCHED_ATTEMPTS):
        if key.startswith(p):
            return key[len(p):].rsplit("/", 1)[0]
    return ""


def _check_blocked_under_lock(op: str, key: str) -> None:
    held = state.held_locks()
    if held:
        state.report(
            "blocked-under-lock",
            f"KV/store round-trip .{op}({key!r}) entered while holding "
            f"{', '.join(held)} — lock scopes must not block",
        )


def _check_unfenced(kv: Any, op: str, args: tuple) -> None:
    keys = _keys_of(op, args)
    if op in ("set", "mset", "cas"):
        bad = [k for k in keys if k.startswith((_SCHED_LEASE, _SCHED_EPOCH))]
        if bad:
            state.report(
                "unfenced-write",
                f"bare .{op} on {bad[0]!r}: lease records install only "
                f"through epoch-compared eval/eval_many; epochs only "
                f"through incr",
            )
        badjob = [k for k in keys if k.startswith(_SCHED_JOB)]
        if badjob:
            state.report(
                "unfenced-write",
                f"bare .{op} on {badjob[0]!r}: manifest/stage/barrier "
                f"records land only through first-writer-wins eval_many "
                f"(jobs.commit_records); the driver lease only through "
                f"term-compared evals",
            )
    elif op in ("delete", "mdel"):
        finished = _finished_mirror(kv)
        for k in keys:
            if not k.startswith(
                (_SCHED_LEASE, _SCHED_EPOCH, _SCHED_ATTEMPTS, _SCHED_JOB)
            ):
                continue
            job = _job_of_task_key(k)
            if job not in finished:
                state.report(
                    "unfenced-write",
                    f".{op} of {k!r} with no sched/finished/{job} tombstone "
                    f"written first — GC must tombstone before deleting",
                )

    # Feed the tombstone mirror.
    if op == "set" and keys and keys[0].startswith(_SCHED_FINISHED):
        _finished_mirror(kv).add(keys[0][len(_SCHED_FINISHED):])
    elif op == "mset" and isinstance(args[0], dict):
        for k in args[0]:
            if isinstance(k, str) and k.startswith(_SCHED_FINISHED):
                _finished_mirror(kv).add(k[len(_SCHED_FINISHED):])


_KV_OPS = (
    "get", "mget", "set", "mset", "setnx", "incr", "cas", "delete", "mdel",
    "exists", "scan", "eval", "eval_many", "rpush", "rpush_many", "lpop",
    "lpop_n", "blpop", "lrange", "llen", "wait_key",
)
_KV_WRITES = {
    "set", "mset", "setnx", "incr", "cas", "delete", "mdel", "eval",
    "eval_many", "rpush", "rpush_many",
}
_STORE_OPS = (
    "put_bytes", "put_many_bytes", "get_bytes", "get_many_bytes", "exists",
    "exists_many", "delete", "delete_many", "delete_prefix", "list", "put",
    "get", "get_many", "put_many", "publish_result", "wait_keys", "wait_put",
)
_BACKEND_OPS = (
    "put", "put_many", "get", "get_many", "exists", "exists_many", "delete",
    "list", "wait_put",
)


def _kv_post(kv: Any, op: str, args: tuple, kwargs: dict, result: Any) -> None:
    """Shadow-store maintenance + torn-read check, after the inner op."""
    shadow = _shadow(kv)
    if op in ("mset", "eval_many"):
        mapping = args[0] if args and isinstance(args[0], dict) else {}
        if len(mapping) >= 2:
            stamp = state.next_stamp()
            if op == "mset":
                values = mapping
            else:
                values = result if isinstance(result, dict) else {}
            stamped = {k: (stamp, values.get(k)) for k in mapping if k in values}
            shards = {k: kv.shard_of(k) for k in stamped}
            shadow.record_batch(stamped, shards)
        else:
            for k in mapping:
                if isinstance(k, str):
                    shadow.invalidate(k)
    elif op == "set" and args:
        shadow.record_single(args[0], args[1] if len(args) > 1 else None, state.next_stamp())
    elif op == "delete" and args:
        shadow.record_single(args[0], _DELETED, state.next_stamp())
    elif op == "mdel" and args and isinstance(args[0], (list, tuple)):
        stamp = state.next_stamp()
        for k in args[0]:
            if isinstance(k, str):
                shadow.record_single(k, _DELETED, stamp)
    elif op in _KV_WRITES:
        # incr/cas/setnx/eval/rpush*: value not cheaply knowable -> the key
        # leaves torn-read tracking rather than risk a stale digest.
        for k in _keys_of(op, args):
            shadow.invalidate(k)
    elif op == "mget" and args and isinstance(args[0], (list, tuple)):
        keys = [k for k in args[0] if isinstance(k, str)]
        if isinstance(result, list) and len(result) == len(keys) and len(keys) >= 2:
            msg = shadow.check_read(keys, result, kv.shard_of)
            if msg:
                state.report("torn-read", msg)


def _record(op: str, args: tuple, result: Any) -> None:
    keys = _keys_of(op, args)
    key = keys[0] if len(keys) == 1 else f"[{len(keys)} keys]" if keys else "?"
    epoch = _epoch_of(keys, result if op in ("eval",) else (args[1] if len(args) > 1 else None))
    state.log_op(op, key, epoch)


def _make_kv_wrapper(cls: type, name: str) -> Callable:
    orig = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        if not state.enabled:
            return orig(self, *args, **kwargs)
        tls = state._tls
        _check_blocked_under_lock(name, _first_key(args))
        if name in _KV_WRITES:
            _check_unfenced(self, name, args)
        tls.depth += 1
        try:
            result = orig(self, *args, **kwargs)
        finally:
            tls.depth -= 1
        if tls.depth == 0:
            _record(name, args, result)
            _kv_post(self, name, args, kwargs, result)
        return result

    wrapper.__name__ = name
    wrapper.__qualname__ = f"Sanitizing{cls.__name__}.{name}"
    return wrapper


def _make_passthrough_wrapper(cls: type, name: str) -> Callable:
    orig = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        if not state.enabled:
            return orig(self, *args, **kwargs)
        tls = state._tls
        _check_blocked_under_lock(name, _first_key(args))
        tls.depth += 1
        try:
            result = orig(self, *args, **kwargs)
        finally:
            tls.depth -= 1
        if tls.depth == 0:
            _record(name, args, result)
        return result

    wrapper.__name__ = name
    wrapper.__qualname__ = f"Sanitizing{cls.__name__}.{name}"
    return wrapper


_dyn_cache: Dict[Tuple[type, str], type] = {}


def _dyn_subclass(cls: type, ops: tuple, kind: str) -> type:
    cached = _dyn_cache.get((cls, kind))
    if cached is not None:
        return cached
    make = _make_kv_wrapper if kind == "kv" else _make_passthrough_wrapper
    ns = {
        name: make(cls, name)
        for name in ops
        if name in {n for k in cls.__mro__ for n in k.__dict__}
    }
    ns["_sanitized_"] = True
    dyn = type(f"_Sanitized{cls.__name__}", (cls,), ns)
    # Register under the module so by-value pickling of instances (e.g. a
    # backend handle shipped to a worker) can resolve the class.
    dyn.__module__ = __name__
    dyn.__qualname__ = dyn.__name__
    globals()[dyn.__name__] = dyn
    _dyn_cache[(cls, kind)] = dyn
    return dyn


def _swap(obj: Any, ops: tuple, kind: str) -> Any:
    if getattr(type(obj), "_sanitized_", False):
        return obj
    obj.__class__ = _dyn_subclass(type(obj), ops, kind)
    return obj


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def SanitizingKVStore(kv: Any) -> Any:
    """Instrument a ``KVStore``/``FileKVStore`` *in place* (class swap) and
    put its shard locks under tracking.  Returns the same object."""
    state.enabled = True
    _swap(kv, _KV_OPS, "kv")
    for i, sh in enumerate(getattr(kv, "_shards", [])):
        if not isinstance(sh.lock, TrackedLock):
            tracked = TrackedLock(sh.lock, f"kv@{id(kv):x}.shard{i}")
            sh.lock = tracked
            sh.cond = threading.Condition(tracked)
    return kv


def SanitizingBackend(backend: Any) -> Any:
    """Instrument a storage backend (or a whole ``ObjectStore``) in place."""
    state.enabled = True
    from repro_torch.storage.object_store import ObjectStore  # local import: no cycle

    if isinstance(backend, ObjectStore):
        _swap(backend, _STORE_OPS, "store")
        SanitizingBackend(backend.backend)
        return backend
    _swap(backend, _BACKEND_OPS, "backend")
    return backend


def sanitize_scheduler(sched: Any) -> Any:
    """Put a ``Scheduler`` handle's internal lock under tracking."""
    state.enabled = True
    if not isinstance(sched._lock, TrackedLock):
        sched._lock = TrackedLock(sched._lock, f"scheduler@{id(sched):x}._lock")
    return sched


# ---------------------------------------------------------------------------
# blanket install (conftest / REPRO_SANITIZE=1)
# ---------------------------------------------------------------------------

_installed = False


def _hook_init(cls: type, fn: Callable[[Any], Any]) -> None:
    orig = cls.__init__

    def __init__(self, *args, **kwargs):  # noqa: N807
        orig(self, *args, **kwargs)
        # Only the most-derived constructor sanitizes (super().__init__
        # chains pass through untouched; the leaf call finishes the swap).
        if type(self) is cls:
            fn(self)

    __init__.__wrapped_by_sanitizer__ = True
    cls.__init__ = __init__


def install() -> None:
    """Patch every built-in KV/store/backend/scheduler constructor so all
    instances created afterwards are sanitized.  Idempotent."""
    global _installed
    if _installed:
        state.enabled = True
        return
    _installed = True
    state.enabled = True

    from repro_torch.core.scheduler import Scheduler
    from repro_torch.storage.file_kv import FileKVStore
    from repro_torch.storage.kv_store import KVStore
    from repro_torch.storage.net_kv import NetBackend, NetKVStore
    from repro_torch.storage.object_store import FileBackend, InMemoryBackend, ObjectStore

    _hook_init(KVStore, SanitizingKVStore)
    _hook_init(FileKVStore, SanitizingKVStore)
    _hook_init(NetKVStore, SanitizingKVStore)
    _hook_init(NetBackend, SanitizingBackend)
    _hook_init(ObjectStore, SanitizingBackend)
    _hook_init(InMemoryBackend, SanitizingBackend)
    _hook_init(FileBackend, SanitizingBackend)
    _hook_init(Scheduler, sanitize_scheduler)
