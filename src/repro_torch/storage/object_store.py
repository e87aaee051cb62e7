"""S3-semantics object store: the bulk state plane of the stateless runtime
(a copy of `repro.storage.object_store`, so that the port imports nothing of
the JAX package).  ``FileBackend`` keeps the JAX package's directory layout,
commit protocol and ``.watch-seq`` ledger frames, so a JAX process and a
torch process can share one root; the wire tier's ``NetBackend`` is in
:mod:`.net_kv`.

Semantics reproduced from the paper's use of S3:
  * whole-object atomic ``put`` / ``get`` (no partial writes ever visible);
  * ``put_if_absent`` — the atomic-write primitive the paper relies on for
    exactly-once result visibility ("We only need atomic writes to remote
    storage for tracking which functions have succeeded");
  * ``list(prefix)`` for completion polling;
  * **no append** (the paper calls this limitation out in §4) — appends must
    be emulated by writing new keys, exactly as PyWren's shuffle does;
  * integrity: every object carries a sha256 etag.

Backends: in-memory (tests, benchmarks) and file-backed (crash-safe via
``os.replace``; used by checkpointing so restarts survive process death).

Data plane (batching + notification):
  * **batched reads** — ``get_many``/``get_many_bytes`` (alias
    ``multi_get``) coalesce N key fetches into one backend call and charge
    *one* amortized round-trip: a single request latency plus the summed
    transfer time, instead of N× latency.  This is the numpywren lesson —
    object-store cost is dominated by per-request latency, so every
    driver-side fan-in (future resolution, shuffle column reads, parameter
    pulls) should ride a multi-get.  Missing keys are omitted from the
    result dict (callers that need all keys pass ``missing="error"``).
  * **batched writes** — ``put_many``/``put_many_bytes`` are the write-side
    mirror: N objects land in one backend call charged as a single request
    latency plus the summed transfer time (``write_latency + Σbytes/bw``),
    and the whole batch fires **one** ``notify_put`` — waiters wake once
    per batch, not once per object.  ``delete_many`` rides the same
    accounting for teardown (shuffle-intermediate GC, per-job GC).  This is
    the other half of the Fig 5/6 request-count bottleneck: map-side
    fan-outs (``shuffle.write_partitions``, input staging) are request-
    bound, not byte-bound, so pipelining the batch amortizes exactly the
    term that saturates first.  ``if_absent`` batches keep per-key
    first-writer-wins semantics; the return value counts keys won.
  * **key watch** (event-driven completion signalling) — every successful
    ``put_bytes`` through this store handle calls ``notify_put``: a
    broadcast on the store's watch condition plus a monotonically
    increasing put sequence number.  Waiters (``wait_keys``, futures)
    snapshot ``put_seq()``, check key existence, then block in
    ``wait_put`` until the sequence advances — the snapshot-then-wait
    ordering means an in-process publish can never be missed between the
    existence check and the wait.
  * wakeup guarantee is **per backend**: the watch condition and sequence
    live on the backend, so a publish through *any* store handle sharing
    that backend wakes every waiter in this process.  Put events carry the
    *keys* that landed (``puts_since``): completion waits retire exactly
    those keys with O(1) bookkeeping per event instead of re-probing the
    backend per wake (and when they must probe — first pass, unknown-key
    events — they use the batched ``exists_many``, one readdir per key
    directory, never one stat per key).  A *different process* sharing a
    ``FileBackend`` directory publishes without reaching this process's
    condition directly; ``FileBackend`` closes that gap with a
    **cross-process watch**: every mutation appends one framed ``op, key``
    record to a per-root ledger (size is the cross-process write sequence
    — monotone and atomic under ``O_APPEND``; rotated atomically past a
    cap), and a per-backend watch thread (``_PollWatcher``) blocks on
    inotify where available — zero wakeups between events — falling back
    to an exponential-backoff stat poll (fast after a change, backing off
    to a small cap when idle, fully parked while nobody waits), converting
    external writes into in-process ``notify_put`` broadcasts.
    ``wait_keys`` therefore no longer needs its fallback re-check tick on
    any built-in backend; the tick (``WATCH_FALLBACK_TICK_S``) survives
    only for out-of-tree cross-process backends without a watcher, and
    every tick-bounded wait is counted in
    ``ObjectStore.fallback_tick_waits`` so tests can assert the
    event-driven path really is tick-free.

Every operation is charged virtual wire time from a
:class:`~repro_torch.storage.perf_model.StorageProfile` and recorded in a
:class:`Ledger` keyed by the calling worker, which the paper-figure
benchmarks aggregate.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
import weakref
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import serialization
from .perf_model import S3_2017, StorageProfile

# Store handles pickle BY REFERENCE (like an S3 client: the serialized form
# is an endpoint, not the data).  Functions shipped through the runtime close
# over store handles; on the worker they must resolve to the *same* store.
_HANDLE_REGISTRY: "weakref.WeakValueDictionary[str, Any]" = weakref.WeakValueDictionary()

# Reconnected handles, one per (kind, root) per process: a foreign process
# unpickling N task closures over one directory store shares one handle —
# N private handles would each run their own watcher thread and group-commit
# counter over the same files.
_RECONNECT_CACHE: Dict[Tuple[str, str], Any] = {}
_RECONNECT_LOCK = threading.Lock()


def _reconnect(spec: Dict[str, Any]) -> Any:
    """Rebuild a handle over the same directory substrate in THIS process —
    the moral equivalent of an S3 client re-opening a connection from its
    endpoint URL.  Only file-backed handles carry a spec (their root path
    *is* the endpoint); in-memory handles are process-local by nature."""
    cache_key = (spec["kind"], spec.get("root") or spec.get("addr"))
    with _RECONNECT_LOCK:
        handle = _RECONNECT_CACHE.get(cache_key)
    if handle is not None:
        return handle
    if spec["kind"] == "object":
        handle = ObjectStore(
            backend=FileBackend(spec["root"], fsync=spec.get("fsync", "auto"))
        )
    elif spec["kind"] == "file_kv":
        from .file_kv import FileKVStore  # local import: file_kv imports us

        handle = FileKVStore(
            spec["root"],
            num_shards=int(spec.get("num_shards", 1)),
            engine=spec.get("engine", "log"),
            fsync=spec.get("fsync", "auto"),
        )
    elif spec["kind"] == "net_kv":
        from .net_kv import NetKVStore  # local import: net_kv imports us

        handle = NetKVStore(spec["addr"])
    elif spec["kind"] == "net_obj":
        from .net_kv import NetBackend  # local import: net_kv imports us

        handle = ObjectStore(backend=NetBackend(spec["addr"]))
    else:
        raise RuntimeError(f"unknown storage endpoint spec {spec!r}")
    with _RECONNECT_LOCK:
        return _RECONNECT_CACHE.setdefault(cache_key, handle)


def _resolve_handle(uid: str, spec: Optional[Dict[str, Any]] = None) -> Any:
    try:
        return _HANDLE_REGISTRY[uid]
    except KeyError:
        pass
    if spec is not None:
        try:
            return _reconnect(spec)
        except Exception as e:
            raise RuntimeError(
                f"storage handle {uid} not live in this process; reconnecting from "
                f"its spec {spec!r} failed: {e}"
            ) from e
    raise RuntimeError(
        f"storage handle {uid} not live in this process and it carries no "
        "reconnect spec (in-memory handles cannot cross processes); use a "
        "FileBackend/FileKVStore-backed handle for cross-process jobs"
    )


class _Endpoint:
    """Mixin giving a class by-reference pickling semantics.

    Same process: the unpickled handle IS the original object (registry
    hit).  Foreign process: handles whose state lives on a shared directory
    (``FileBackend``-backed stores, ``FileKVStore``) additionally carry an
    ``_endpoint_spec()`` reconnect recipe, so a task closure registered by
    one driver still resolves its stores after that driver is dead, and a
    task a worker pool in another process leases resolves them there.  In-memory handles
    return no spec and keep raising in a foreign process."""

    def _register_endpoint(self) -> None:
        self._endpoint_uid = f"{type(self).__name__}-{uuid.uuid4().hex}"
        _HANDLE_REGISTRY[self._endpoint_uid] = self

    def _endpoint_spec(self) -> Optional[Dict[str, Any]]:
        return None

    def __reduce__(self):
        return (_resolve_handle, (self._endpoint_uid, self._endpoint_spec()))


@dataclass
class OpRecord:
    worker: str
    op: str  # "get" | "put" | "list" | "delete" | "head"
    key: str
    nbytes: int
    vtime_s: float  # modeled wire duration
    wall_t: float  # real monotonic time of issue (ordering/debug only)


class Ledger:
    """Thread-safe per-worker record of storage ops in virtual time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[OpRecord] = []

    def record(self, rec: OpRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def records(self) -> List[OpRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- aggregation helpers used by benchmarks -------------------------
    def totals(self) -> Dict[str, Tuple[int, float]]:
        """op -> (total bytes, total virtual seconds)."""
        out: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))
        for r in self.records():
            b, t = out[r.op]
            out[r.op] = (b + r.nbytes, t + r.vtime_s)
        return dict(out)

    def per_worker(self) -> Dict[str, Dict[str, Tuple[int, float]]]:
        out: Dict[str, Dict[str, Tuple[int, float]]] = defaultdict(
            lambda: defaultdict(lambda: (0, 0.0))
        )
        for r in self.records():
            b, t = out[r.worker][r.op]
            out[r.worker][r.op] = (b + r.nbytes, t + r.vtime_s)
        return {w: dict(ops) for w, ops in out.items()}


class KeyExistsError(KeyError):
    pass


# Fallback re-check interval for key watchers: covers publishes that bypass
# this store handle's notifications on a cross-process backend *without* a
# watch thread (no built-in backend is one anymore; see _PollWatcher).
WATCH_FALLBACK_TICK_S = 0.25

# _PollWatcher backoff bounds: fast enough after a change that a
# cross-process wake is near-immediate, capped so an idle watcher costs a
# couple of stat() calls per _WATCH_MAX_BACKOFF_S at worst.
_WATCH_MIN_BACKOFF_S = 0.002
_WATCH_MAX_BACKOFF_S = 0.05


class _PollWatcher:
    """Watch filesystem signals for cross-process writes.

    Watches a fixed set of paths by ``stat`` signature ``(size, mtime_ns)``
    — log/sequence files grow monotonically and a POSIX ``rename``/
    ``unlink`` bumps the parent dirent's mtime, so together they cover
    every mutation a foreign process can make.

    Two modes, picked at thread start:

    * **inotify** (Linux, the default where it works) — a ctypes binding
      (:mod:`repro_torch.storage.inotify`) watches the paths' parent directories
      and the thread blocks in ``poll()`` on the inotify fd: *zero* timed
      wakeups between events (``poll_wakeups`` stays 0), wake latency is
      the kernel's, not a backoff bound.  Every event is resolved back to
      changed paths by the same stat-signature comparison, so the contract
      is identical to poll mode.
    * **backoff poll** (portable fallback, ``mode == "poll"``) —
      exponential backoff (reset to ``min_s`` on every observed change)
      and **waiter-gated**: with zero registered waiters the thread parks
      on an event and costs nothing.  Each timed scan increments
      ``poll_wakeups`` (tests assert inotify mode keeps it 0).

    In both modes the comparison baseline persists across idle periods, so
    a write landing while parked is detected on the first pass after a
    waiter registers — the snapshot-then-check-then-wait contract of
    ``wait_put`` does the rest."""

    def __init__(
        self,
        paths: List[str],
        on_change,
        min_s: float = _WATCH_MIN_BACKOFF_S,
        max_s: float = _WATCH_MAX_BACKOFF_S,
        use_inotify: Optional[bool] = None,
    ) -> None:
        self._paths = list(paths)
        self._on_change = on_change
        self._min_s = min_s
        self._max_s = max_s
        self._use_inotify = use_inotify  # None = auto-detect
        self._lock = threading.Lock()
        self._waiters = 0
        self._wake = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._pipe_r, self._pipe_w = os.pipe()  # close() → wake the poll()
        self.mode = "poll"  # "inotify" once the event loop takes over
        self.poll_wakeups = 0  # timed scans in poll mode (0 under inotify)

    @staticmethod
    def _sig(path: str) -> Tuple[int, int, int]:
        """Change signature: (inode, size, mtime).  The inode matters since
        watched files are non-monotone across replacement — KV
        compaction and ledger rotation shrink the file via atomic rename —
        so a shrink-then-regrow to the same size inside one mtime granule
        would collide on (size, mtime) alone; the rename always installs a
        new inode, which cannot collide.  Within one inode the files are
        append-only, so size growth covers the rest."""
        try:
            st = os.stat(path)
        except OSError:
            return (0, 0, 0)
        return (st.st_ino, st.st_size, st.st_mtime_ns)

    def add_waiter(self) -> None:
        with self._lock:
            self._waiters += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="fs-watch"
                )
                self._thread.start()
            self._wake.set()

    def remove_waiter(self) -> None:
        with self._lock:
            self._waiters = max(0, self._waiters - 1)

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        with self._lock:
            started = self._thread is not None
            if self._pipe_w is not None:
                try:
                    os.write(self._pipe_w, b"x")
                except OSError:
                    pass
        if not started:
            self._close_pipe()

    def _close_pipe(self) -> None:
        with self._lock:
            for attr in ("_pipe_r", "_pipe_w"):
                fd = getattr(self, attr)
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                    setattr(self, attr, None)

    def _scan(self, last: List[Tuple[int, int]]) -> List[int]:
        """Compare every path's stat signature against ``last`` (updated in
        place); returns the indexes that changed."""
        changed = []
        for i, p in enumerate(self._paths):
            sig = self._sig(p)
            if sig != last[i]:
                last[i] = sig
                changed.append(i)
        return changed

    def _try_inotify(self):
        if self._use_inotify is False:
            return None
        try:
            from .inotify import Inotify

            if not Inotify.available():
                return None
            ino = Inotify()
            seen = set()
            for p in self._paths:
                d = p if os.path.isdir(p) else (os.path.dirname(p) or ".")
                if d not in seen:
                    seen.add(d)
                    ino.add_watch(d)
            return ino
        except Exception:
            return None

    def _run(self) -> None:
        if self._closed:
            self._close_pipe()  # close() deferred cleanup to us
            return
        ino = self._try_inotify()
        try:
            if ino is not None:
                self._run_inotify(ino)
            else:
                self._run_poll()
        finally:
            if ino is not None:
                ino.close()
            self._close_pipe()

    def _run_inotify(self, ino) -> None:
        import select

        self.mode = "inotify"
        last = [self._sig(p) for p in self._paths]
        poller = select.poll()
        poller.register(ino.fileno(), select.POLLIN)
        poller.register(self._pipe_r, select.POLLIN)
        # The baseline above races the mode flip: a write that landed just
        # before is already folded in; one landing after raises an event.
        while not self._closed:
            poller.poll()  # block: no timeout, no timed wakeups
            if self._closed:
                return
            ino.read_events()  # drain the kernel queue (names unused)
            changed = self._scan(last)
            if changed:
                self._on_change(changed)

    def _run_poll(self) -> None:
        last = [self._sig(p) for p in self._paths]
        backoff = self._min_s
        while not self._closed:
            with self._lock:
                idle = self._waiters == 0
                if idle:
                    self._wake.clear()
            if idle:
                # Park until a waiter registers; `last` persists, so writes
                # landing while parked are seen on the first pass after wake.
                self._wake.wait()
                continue
            self.poll_wakeups += 1
            changed = self._scan(last)
            if changed:
                backoff = self._min_s
                self._on_change(changed)
            else:
                backoff = min(backoff * 2.0, self._max_s)
            time.sleep(backoff)


class _Backend:
    # True when writers in *other processes* can mutate the backing state
    # without going through an in-process store handle.  Backends that also
    # run a cross-process watcher (``self_watching``) convert those foreign
    # writes into in-process notifications, so their waiters stay purely
    # event-driven; only a cross-process backend *without* a watcher needs
    # the fallback re-check tick.
    cross_process = False
    self_watching = False

    # True when the backend's own event plane already reports this handle's
    # writes back to it (the net backend: the server pushes a watch frame
    # for every mutation, including ours).  ``ObjectStore`` then skips its
    # local ``notify_put`` after puts — otherwise every batch would wake
    # waiters twice, once locally and once on the echoed event.
    echoes_puts = False

    # True when a put CONSUMES its blob before returning (written to disk,
    # sent on a socket), so callers may hand over a ``memoryview`` of live
    # array memory instead of copying to bytes first.  False for backends
    # that store the reference (the in-memory backend): an aliased view
    # would let later array mutation corrupt the stored object.
    zero_copy_puts = False

    # How many recent put events carry their key lists before waiters must
    # fall back to an existence probe (bounds memory, not correctness).
    _RECENT_PUTS = 512

    def _init_watch(self) -> None:
        """Watch state lives on the *backend*, not the store handle: two
        ``ObjectStore`` handles sharing one backend must wake each other's
        waiters (subclass ``__init__`` calls this)."""
        self._watch_cv = threading.Condition()
        self._watch_seq = 0
        # Ring of (seq, keys-or-None): which keys each recent put event
        # covered.  None = unknown (a cross-process write relayed by a
        # watcher) — consumers must re-probe.
        self._recent_puts: "deque" = deque(maxlen=self._RECENT_PUTS)

    def notify_put(self, keys: Optional[List[str]] = None) -> None:
        """Advance the put sequence and wake waiters.  ``keys`` names what
        just became visible; waiters then retire exactly those keys instead
        of re-probing the backend (``puts_since``).  Pass None when the set
        is unknown (out-of-band/cross-process writes)."""
        with self._watch_cv:
            self._watch_seq += 1
            self._recent_puts.append(
                (self._watch_seq, tuple(keys) if keys is not None else None)
            )
            self._watch_cv.notify_all()

    def put_seq(self) -> int:
        with self._watch_cv:
            return self._watch_seq

    def puts_since(self, last_seq: int) -> Tuple[int, Optional[set]]:
        """(current seq, keys that landed after ``last_seq``) — or
        ``(seq, None)`` when the set is unknown (ring overflow, or any
        event without keys), in which case the caller re-probes.  This is
        what makes an N-task completion wait O(1) bookkeeping per event
        instead of a backend probe per wake."""
        with self._watch_cv:
            cur = self._watch_seq
            if cur == last_seq:
                return cur, set()
            # Ring seqs are contiguous (one entry per bump): complete
            # coverage of (last_seq, cur] iff the ring reaches back far
            # enough and every covered event knows its keys.
            if not self._recent_puts or self._recent_puts[0][0] > last_seq + 1:
                return cur, None
            keys: set = set()
            for seq, ks in self._recent_puts:
                if seq <= last_seq:
                    continue
                if ks is None:
                    return cur, None
                keys.update(ks)
            return cur, keys

    def wait_put(self, last_seq: int, timeout_s: float) -> int:
        with self._watch_cv:
            if self._watch_seq == last_seq:
                self._watch_cv.wait(timeout_s)
            return self._watch_seq

    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        """Batched fetch: returns present keys only (missing keys omitted).
        Backends override to serve the whole batch in one locked pass."""
        out: Dict[str, bytes] = {}
        for key in keys:
            try:
                out[key] = self.get(key)
            except (KeyError, FileNotFoundError):
                continue
        return out

    def put_many(self, items: Dict[str, bytes], *, if_absent: bool) -> int:
        """Batched write: land every item, returning how many were written
        (``if_absent`` keeps per-key first-writer-wins; losers don't count).
        Backends override to serve the whole batch in one locked pass."""
        won = 0
        for key, blob in items.items():
            if self.put(key, blob, if_absent=if_absent):
                won += 1
        return won

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def exists_many(self, keys: List[str]) -> set:
        """Batched existence: the subset of ``keys`` present.  Backends
        override to answer the whole batch in one pass — completion waits
        (futures, ``wait_keys``) re-check every pending key on every wake,
        so per-key probes turn an N-task fan-in into O(N²) stats."""
        return {k for k in keys if self.exists(k)}

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError


class InMemoryBackend(_Backend):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}
        self._init_watch()

    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        with self._lock:
            if if_absent and key in self._data:
                return False
            self._data[key] = blob
            return True

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._data[k] for k in keys if k in self._data}

    def put_many(self, items: Dict[str, bytes], *, if_absent: bool) -> int:
        with self._lock:
            won = 0
            for key, blob in items.items():
                if if_absent and key in self._data:
                    continue
                self._data[key] = blob
                won += 1
            return won

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._data[key]

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def exists_many(self, keys: List[str]) -> set:
        with self._lock:
            return {k for k in keys if k in self._data}

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class FileBackend(_Backend):
    """Directory-backed store.  Writes are crash-atomic: write temp file,
    then commit — ``os.replace`` for plain puts, ``os.link`` for
    ``if_absent`` puts.  The link either creates the final dirent atomically
    or fails ``EEXIST``, so two *processes* racing a ``put_if_absent``
    cannot both win (the first-writer-wins contract the fenced result
    publishes ride on), and either way only a complete object ever becomes
    visible.

    Durability is a policy (``fsync=``), mirroring ``FileKVStore``'s:
    ``auto`` (default) fsyncs per put for keys under ``durable_prefixes``
    (``ckpt/`` — checkpoints must survive a machine crash) and
    group-commits the rest — one ``os.sync()`` every ``fsync_batch_n``
    puts (objects are distinct files, so a per-file fsync could not flush
    its predecessors; the single syscall flushes them all) and one more on
    ``close()``; ``always`` fsyncs every put; ``batch``
    group-commits everything; ``never`` is OS-buffered.  *Visibility* is unaffected — the rename/link commit makes
    an object readable by every process immediately; the policy only
    decides what survives a machine (not process) crash.  Data-plane puts
    (``input/``, ``result/``, shuffle intermediates) are re-drivable from
    the job, exactly the paper's recovery story, so they default batched.

    Cross-process watch: every mutation appends one framed record
    (``op, key`` — :func:`repro_torch.storage.kv_store.encode_frame`, the same
    framing as the KV's shard logs) to the root's ``.watch-seq`` ledger
    after it lands, so the ledger's *size* is a monotone cross-process
    write sequence (``O_APPEND`` appends are atomic) and its tail says
    *which* keys moved (debuggability).  The ledger is an event channel,
    not state: when it outgrows a cap it is swapped for a fresh one via
    atomic rename (itself a watchable dirent change).  The first
    ``wait_put`` starts a ``_PollWatcher`` over the ledger plus the root
    dirent's mtime (rename/unlink bump it even for writers that skip the
    ledger append); any observed change fires this process's
    ``notify_put``, so waiters sharing the directory across processes are
    woken without a fallback re-check tick.  The watcher blocks on inotify
    where available and otherwise backoff-polls, waiter-gated."""

    cross_process = True
    self_watching = True
    zero_copy_puts = True  # every put writes the blob out before returning

    _SEQ_NAME = ".watch-seq"
    _SEQ_ROTATE_BYTES = 1 << 20  # swap the event ledger past 1 MiB

    def __init__(
        self,
        root: str,
        *,
        fsync: str = "auto",
        durable_prefixes: Tuple[str, ...] = ("ckpt/",),
        fsync_batch_n: int = 32,
        watch_ledger: bool = True,
    ) -> None:
        if fsync == "commit":
            fsync = "always"  # FileKVStore's name for the same policy
        if fsync not in ("auto", "always", "batch", "never"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        # watch_ledger=False: skip the .watch-seq append per mutation.  Only
        # for a sole-owner backend whose host pushes its own change events
        # (the repro-kvd server) — with no foreign watchers, the ledger is
        # pure overhead.
        self.watch_ledger = watch_ledger
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fsync = fsync
        self.durable_prefixes = tuple(durable_prefixes)
        self.fsync_batch_n = fsync_batch_n
        self._puts_since_sync = 0
        self._lock = threading.Lock()
        self._seq_path = os.path.join(self.root, self._SEQ_NAME)
        self._seq_fd: Optional[int] = None  # cached O_APPEND ledger fd
        self._made_dirs: set = set()  # subdirs known created (saves a mkdir RPC)
        self._io_pool = None  # lazy thread pool for batched get/put fan-out
        self._watcher: Optional[_PollWatcher] = None
        self._init_watch()

    # Batches below this size aren't worth the thread-pool handoff.
    _PARALLEL_BATCH_MIN = 8

    def _pool(self):
        """Small worker pool for batched I/O: on a network filesystem each
        open/write/rename is a round trip that releases the GIL, so a
        64-object batch completes in ~8 round-trip times instead of 64."""
        if self._io_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                if self._io_pool is None:
                    self._io_pool = ThreadPoolExecutor(
                        max_workers=8, thread_name_prefix="fb-io"
                    )
        return self._io_pool

    # Keys are sharded into one subdirectory per key *directory* (everything
    # up to the last "/", %2F-encoded): ``result/job/t3`` lives at
    # ``root/result%2Fjob/t3``.  A flat directory makes every batched
    # existence probe / prefix list pay a readdir of the WHOLE store — on a
    # network filesystem that turns an N-task completion wait into
    # O(total objects) per wake.  Sharded, a job's probes list only the
    # job's own directory.
    def _split(self, key: str) -> Tuple[str, str]:
        if "/" in key:
            head, base = key.rsplit("/", 1)
            return head.replace("/", "%2F"), base
        return "", key

    def _path(self, key: str) -> str:
        sub, base = self._split(key)
        if not sub:
            return os.path.join(self.root, base)
        return os.path.join(self.root, sub, base)

    def _ensure_dir(self, key: str) -> None:
        sub, _ = self._split(key)
        if sub and sub not in self._made_dirs:
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
            self._made_dirs.add(sub)

    def _durable(self, key: str) -> bool:
        """Does this put fsync before commit?  (Policy; module docstring.)
        Non-durable puts are group-committed by :meth:`_note_lazy_puts` —
        an ``os.sync()`` every ``fsync_batch_n`` puts — because objects are
        DISTINCT files: fsyncing the Nth file would not flush the N-1
        before it, so per-file fsync cannot implement a group commit."""
        if self.fsync == "always":
            return True
        if self.fsync == "never":
            return False
        return self.fsync == "auto" and key.startswith(self.durable_prefixes)

    def _note_lazy_puts(self, n: int) -> None:
        """Group commit for non-fsynced puts (caller holds the lock): one
        ``os.sync()`` flushes every file the batch dirtied in a single
        syscall, bounding machine-crash data loss to ``fsync_batch_n``
        puts.  ``never`` opts out entirely (OS-buffered)."""
        if self.fsync == "never" or n <= 0:
            return
        self._puts_since_sync += n
        if self._puts_since_sync >= self.fsync_batch_n:
            self._puts_since_sync = 0
            os.sync()

    def _bump_cross_seq(self, op: str, keys) -> None:
        """Advance the cross-process write sequence: one atomic O_APPEND
        frame naming the mutated keys (one frame per batch; caller holds
        ``self._lock``).  Other processes' watchers detect the size growth;
        the ledger is rotated (atomic rename — itself a watchable event)
        once it outgrows the cap, so it never accretes unboundedly.  The fd
        is cached — one write + one fstat per mutation, not open/close round
        trips; the fstat's ``st_nlink`` doubles as the detector for a peer's
        rotation (our append went to the unlinked ledger: re-append to the
        fresh one)."""
        if not self.watch_ledger:
            return
        from .kv_store import encode_frame  # late: kv_store imports us

        frame = encode_frame([(op, k, None) for k in keys])
        st = None
        for _attempt in range(2):
            if self._seq_fd is None:
                self._seq_fd = os.open(
                    self._seq_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                )
            os.write(self._seq_fd, frame)
            # The fstat doubles as the rotation-due check AND the detector
            # for a peer having rotated underneath us: st_nlink == 0 means
            # our frame just went to the unlinked ledger where no watcher
            # would ever see it — a lost cross-process wake — so re-append
            # to the live one.  One write + one fstat per mutation (the
            # cached fd already saved the open/close round trips); skipping
            # the fstat would trade a real liveness hole for ~0.4 ms.
            st = os.fstat(self._seq_fd)
            if st.st_nlink > 0:
                break
            os.close(self._seq_fd)
            self._seq_fd = None
        if st is not None and st.st_nlink > 0 and st.st_size > self._SEQ_ROTATE_BYTES:
            os.close(self._seq_fd)
            self._seq_fd = None
            tmp = f"{self._seq_path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb"):
                pass
            os.replace(tmp, self._seq_path)

    def _ensure_watcher(self) -> _PollWatcher:
        with self._lock:
            if self._watcher is None:
                self._watcher = _PollWatcher(
                    [self._seq_path, self.root],
                    lambda _changed: self.notify_put(),
                )
            return self._watcher

    def wait_put(self, last_seq: int, timeout_s: float) -> int:
        # Register with the cross-process watcher for the duration of the
        # wait: foreign writes become in-process notify_put broadcasts, so
        # the base condition wait needs no fallback tick.
        watcher = self._ensure_watcher()
        watcher.add_waiter()
        try:
            return super().wait_put(last_seq, timeout_s)
        finally:
            watcher.remove_waiter()

    def close(self) -> None:
        """Stop the watch thread, flush pending group commits, and release
        cached fds/pools (tests; daemon threads otherwise)."""
        with self._lock:
            if self._watcher is not None:
                self._watcher.close()
                self._watcher = None
            if self._seq_fd is not None:
                os.close(self._seq_fd)
                self._seq_fd = None
            if self._io_pool is not None:
                self._io_pool.shutdown(wait=False)
                self._io_pool = None
            if self._puts_since_sync and self.fsync in ("auto", "batch"):
                self._puts_since_sync = 0
                # reprolint: disable=LOCK001(shutdown-only flush; no concurrent critical section contends for this lock by then)
                os.sync()

    def _put_one(self, key: str, blob: bytes, *, if_absent: bool, durable: bool) -> bool:
        """Land one object (caller holds the lock, decided durability, and
        bumps the seq; thread-safe given distinct keys — batched puts fan
        out over the I/O pool)."""
        self._ensure_dir(key)
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        if if_absent:
            # Atomic cross-process first-writer-wins: link either creates
            # the dirent or fails EEXIST — no pre-check needed (a racing
            # process could land between a check and the link anyway, and
            # on the common first-publish path the check is a wasted round
            # trip; a duplicate just pays its tmp write and loses here).
            try:
                os.link(tmp, path)
            except FileExistsError:
                os.remove(tmp)
                return False
            os.remove(tmp)
        else:
            os.replace(tmp, path)
        return True

    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        # The object commit itself is lock-free: the tmp name is unique per
        # thread and the final link/replace is atomic, so concurrent puts —
        # even of the same key — race safely (first link wins).  The lock
        # guards only the policy counter and the ledger fd, so N workers
        # publish results concurrently instead of queueing on each other's
        # network-fs round trips.
        durable = self._durable(key)
        if not self._put_one(key, blob, if_absent=if_absent, durable=durable):
            return False
        with self._lock:
            self._note_lazy_puts(0 if durable else 1)
            self._bump_cross_seq("put", [key])
        return True

    def put_many(self, items: Dict[str, bytes], *, if_absent: bool) -> int:
        """Batched write: every object lands (fanned out over the I/O pool —
        each commit is an independent round trip on its own key), then ONE
        framed ledger append covers the whole batch — the disk-append
        mirror of the one coalesced ``notify_put`` the store layer fires."""
        durable = {k: self._durable(k) for k in items}
        if len(items) < self._PARALLEL_BATCH_MIN:
            won_keys = [
                k
                for k, blob in items.items()
                if self._put_one(k, blob, if_absent=if_absent, durable=durable[k])
            ]
        else:
            results = list(
                self._pool().map(
                    lambda kv: (
                        kv[0],
                        self._put_one(
                            kv[0], kv[1], if_absent=if_absent, durable=durable[kv[0]]
                        ),
                    ),
                    items.items(),
                )
            )
            won_keys = [k for k, won in results if won]
        if won_keys:
            with self._lock:
                self._note_lazy_puts(sum(1 for k in won_keys if not durable[k]))
                self._bump_cross_seq("put", won_keys)
        return len(won_keys)

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        """Batched fetch, fanned out over the I/O pool: N network-fs opens
        overlap instead of serializing (each is a GIL-releasing round
        trip).  Missing keys are omitted, as in the base contract."""
        if len(keys) < self._PARALLEL_BATCH_MIN:
            return super().get_many(keys)

        def _read(key: str):
            try:
                return key, self.get(key)
            except (KeyError, FileNotFoundError):
                return key, None

        out: Dict[str, bytes] = {}
        for key, blob in self._pool().map(_read, keys):
            if blob is not None:
                out[key] = blob
        return out

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def exists_many(self, keys: List[str]) -> set:
        """One directory listing per key-directory answers the whole batch:
        N stats collapse into a few readdirs — on a network filesystem each
        stat is a round trip, so this is what keeps an N-task completion
        wait O(N) total instead of O(N²).  Thanks to subdirectory sharding
        each readdir covers only the probed keys' own directory (a job's
        results), not the whole store."""
        by_dir: Dict[str, List[Tuple[str, str]]] = {}
        for k in keys:
            sub, base = self._split(k)
            by_dir.setdefault(sub, []).append((k, base))
        present = set()
        for sub, group in by_dir.items():
            if len(group) < 8:
                present.update(k for k, _ in group if self.exists(k))
                continue
            try:
                names = set(os.listdir(os.path.join(self.root, sub)))
            except OSError:
                continue  # directory never created: none of these exist
            present.update(k for k, base in group if base in names)
        return present

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            return
        with self._lock:
            self._bump_cross_seq("del", [key])

    @staticmethod
    def _is_plane_file(name: str) -> bool:
        # temp files and watch-plane files (".watch-seq" etc.)
        return name.startswith(".") or name.endswith(".tmp") or ".tmp." in name

    def list(self, prefix: str) -> List[str]:
        out = []
        try:
            entries = list(os.scandir(self.root))
        except OSError:
            return out
        for entry in entries:
            name = entry.name
            if self._is_plane_file(name):
                continue
            if entry.is_dir():
                decoded = name.replace("%2F", "/")
                # Prune subdirectories that can't hold matching keys.
                head = decoded + "/"
                if not (head.startswith(prefix) or prefix.startswith(head)):
                    continue
                for fname in os.listdir(entry.path):
                    if self._is_plane_file(fname):
                        continue
                    key = head + fname
                    if key.startswith(prefix):
                        out.append(key)
            elif name.startswith(prefix):
                out.append(name)
        return sorted(out)


class ObjectStore(_Endpoint):
    """The remote bulk store.  All durable runtime state lives here."""

    def __init__(
        self,
        backend: Optional[_Backend] = None,
        profile: StorageProfile = S3_2017,
        ledger: Optional[Ledger] = None,
    ) -> None:
        self.backend = backend or InMemoryBackend()
        self.profile = profile
        self.ledger = ledger or Ledger()
        # How many tick-bounded (non-event-driven) waits wait_keys has done
        # on this handle.  Built-in backends are all event-driven now, so
        # tests assert this stays 0; a nonzero count means some waiter fell
        # back to polling (an out-of-tree cross-process backend, or an
        # explicit poll_s).
        self.fallback_tick_waits = 0
        self._register_endpoint()

    def _endpoint_spec(self) -> Optional[Dict[str, Any]]:
        # A FileBackend-backed store reconnects by directory in a foreign
        # process (see _Endpoint); the profile/ledger are per-handle
        # accounting, not shared state, so the reconnected handle gets
        # fresh defaults.
        if isinstance(self.backend, FileBackend):
            return {
                "kind": "object",
                "root": self.backend.root,
                "fsync": self.backend.fsync,
            }
        # Other cross-process backends (the net backend) carry their own
        # endpoint spec — the address is the endpoint.
        spec_fn = getattr(self.backend, "endpoint_spec", None)
        if spec_fn is not None:
            return spec_fn()
        return None

    # ---- key watch (notification plane) --------------------------------
    # Watch state lives on the backend so that two store handles sharing
    # one backend (e.g. two ObjectStores over the same InMemoryBackend)
    # wake each other's waiters; these methods delegate.
    def notify_put(self, key: Optional[str] = None) -> None:
        """Wake every watcher of this store's backend: ``key`` just became
        visible.  Called by ``put_bytes`` on each successful write; external
        feeders writing to the backend out of band may call it too (with no
        key if they don't know what changed — waiters then re-probe)."""
        self.backend.notify_put([key] if key is not None else None)

    def put_seq(self) -> int:
        """Snapshot of the backend's put counter; pass to :meth:`wait_put`."""
        return self.backend.put_seq()

    def puts_since(self, last_seq: int):
        """Delegates to the backend: see ``_Backend.puts_since``."""
        return self.backend.puts_since(last_seq)

    def wait_put(self, last_seq: int, timeout_s: float) -> int:
        """Block until any put lands on the backend after the ``last_seq``
        snapshot (or the timeout elapses); returns the current sequence."""
        return self.backend.wait_put(last_seq, timeout_s)

    # ---- raw byte plane ------------------------------------------------
    def put_bytes(
        self, key: str, blob: bytes, *, worker: str = "-", if_absent: bool = False
    ) -> bool:
        won = self.backend.put(key, blob, if_absent=if_absent)
        self.ledger.record(
            OpRecord(worker, "put", key, len(blob), self.profile.write_time(len(blob)), time.monotonic())
        )
        if won and not self.backend.echoes_puts:
            self.notify_put(key)
        return won

    def put_many_bytes(
        self, items: Dict[str, bytes], *, worker: str = "-", if_absent: bool = False
    ) -> int:
        """Batched write: one backend call, one amortized round-trip.

        Mirrors :meth:`get_many_bytes` on the write side — N objects cost
        ``write_latency + Σbytes/bw`` instead of ``N·latency + …``, the
        pipelined-PUT amortization.  The whole batch fires exactly one
        ``notify_put`` (waiters re-check their predicate once per batch).
        Returns the number of keys written; with ``if_absent=True`` each key
        keeps first-writer-wins semantics and losers are not counted."""
        if not items:
            return 0
        won = self.backend.put_many(dict(items), if_absent=if_absent)
        total = sum(len(b) for b in items.values())
        vt = self.profile.write_latency_s + total / self.profile.write_bw_per_conn
        self.ledger.record(
            OpRecord(worker, "mput", f"[{len(items)} keys]", total, vt, time.monotonic())
        )
        if won and not self.backend.echoes_puts:
            # All batch keys are visible now (if_absent losers existed
            # already), so the single coalesced wakeup can name them all.
            self.backend.notify_put(list(items.keys()))
        return won

    def get_bytes(self, key: str, *, worker: str = "-") -> bytes:
        blob = self.backend.get(key)
        self.ledger.record(
            OpRecord(worker, "get", key, len(blob), self.profile.read_time(len(blob)), time.monotonic())
        )
        return blob

    def get_many_bytes(self, keys: List[str], *, worker: str = "-") -> Dict[str, bytes]:
        """Batched fetch: one backend call, one amortized round-trip.

        Charged as a single request latency plus the summed transfer time —
        N keys cost ``latency + Σbytes/bw`` instead of ``N·latency + …``.
        Missing keys are omitted from the returned dict."""
        blobs = self.backend.get_many(list(keys))
        total = sum(len(b) for b in blobs.values())
        vt = self.profile.read_latency_s + total / self.profile.read_bw_per_conn
        self.ledger.record(
            OpRecord(worker, "mget", f"[{len(keys)} keys]", total, vt, time.monotonic())
        )
        return blobs

    def exists(self, key: str, *, worker: str = "-") -> bool:
        ok = self.backend.exists(key)
        self.ledger.record(
            OpRecord(worker, "head", key, 0, self.profile.read_latency_s, time.monotonic())
        )
        return ok

    def exists_many(self, keys: List[str], *, worker: str = "-") -> set:
        """Batched existence probe: the subset of ``keys`` present, charged
        as one amortized round-trip (HEADs are request-bound, exactly like
        ``mdel``).  Completion waits ride this — see ``wait_keys``."""
        present = self.backend.exists_many(list(keys))
        self.ledger.record(
            OpRecord(
                worker, "mhead", f"[{len(keys)} keys]", 0,
                self.profile.read_latency_s, time.monotonic(),
            )
        )
        return present

    def delete(self, key: str, *, worker: str = "-") -> None:
        self.backend.delete(key)
        self.ledger.record(
            OpRecord(worker, "delete", key, 0, self.profile.write_latency_s, time.monotonic())
        )

    def delete_many(self, keys: List[str], *, worker: str = "-") -> None:
        """Batched delete: one amortized round-trip for the whole batch
        (cf. :meth:`get_many_bytes` — per-request latency, not bytes,
        dominates deletes)."""
        for k in keys:
            # reprolint: disable=BATCH001(this IS the batched verb: backend deletes are local unlinks, charged one amortized round-trip below)
            self.backend.delete(k)
        self.ledger.record(
            OpRecord(
                worker, "mdel", f"[{len(keys)} keys]", 0,
                self.profile.write_latency_s, time.monotonic(),
            )
        )

    def delete_prefix(self, prefix: str, *, worker: str = "-") -> int:
        """Delete every key under ``prefix`` (job GC); one list + one
        batched delete round-trip.  Returns the count."""
        keys = self.list(prefix, worker=worker)
        if keys:
            self.delete_many(keys, worker=worker)
        return len(keys)

    def list(self, prefix: str, *, worker: str = "-") -> List[str]:
        keys = self.backend.list(prefix)
        self.ledger.record(
            OpRecord(worker, "list", prefix, 0, self.profile.read_latency_s, time.monotonic())
        )
        return keys

    # ---- object plane (serialized values) ------------------------------
    def put(self, key: str, value: Any, *, worker: str = "-", if_absent: bool = False) -> bool:
        return self.put_bytes(key, serialization.dumps(value), worker=worker, if_absent=if_absent)

    def get(self, key: str, *, worker: str = "-") -> Any:
        return serialization.loads(self.get_bytes(key, worker=worker))

    def get_many(
        self, keys: List[str], *, worker: str = "-", missing: str = "omit"
    ) -> Dict[str, Any]:
        """Batched object fetch (see :meth:`get_many_bytes` for the cost
        model).  ``missing="omit"`` drops absent keys from the result;
        ``missing="error"`` raises ``KeyError`` naming them."""
        blobs = self.get_many_bytes(keys, worker=worker)
        if missing == "error" and len(blobs) < len(set(keys)):
            absent = [k for k in keys if k not in blobs]
            raise KeyError(f"{len(absent)} keys absent, e.g. {absent[:3]}")
        return {k: serialization.loads(b) for k, b in blobs.items()}

    # Redis-style alias; some call sites read better as multi_get.
    multi_get = get_many

    def put_many(
        self, items: Dict[str, Any], *, worker: str = "-", if_absent: bool = False
    ) -> int:
        """Batched object write (see :meth:`put_many_bytes` for the cost
        model): serialize every value, land the batch in one amortized
        round-trip, wake watchers once.  Returns the number of keys
        written."""
        return self.put_many_bytes(
            {k: serialization.dumps(v) for k, v in items.items()},
            worker=worker,
            if_absent=if_absent,
        )

    def put_content_addressed(self, prefix: str, value: Any, *, worker: str = "-") -> str:
        """PyWren's 'globally unique keys': content-hash the blob.  Duplicate
        puts of identical content are idempotent by construction."""
        key, blob = serialization.dumps_with_key(prefix, value)
        self.put_bytes(key, blob, worker=worker, if_absent=True)
        return key

    # ---- completion signalling (the paper's atomic-result contract) ----
    def publish_result(self, key: str, value: Any, *, worker: str = "-") -> bool:
        """Atomic publish: first writer wins; late/speculative duplicates are
        silently discarded.  Existence of ``key`` == task completion."""
        return self.put(key, value, worker=worker, if_absent=True)

    def watch_tick_s(self, poll_s: Optional[float] = None) -> Optional[float]:
        """Fallback re-check interval for key watchers on this store.

        ``None`` means purely event-driven: every write either goes through
        an in-process handle (which fires ``notify_put``) or is detected by
        the backend's own cross-process watcher (``FileBackend``'s seq-file
        + dirent-mtime ``_PollWatcher``), so waiters never need to poll.
        Only a cross-process backend *without* a watcher returns the
        fallback tick.  An explicit ``poll_s`` always wins
        (backward-compatible knob)."""
        if poll_s is not None:
            return poll_s
        if self.backend.cross_process and not self.backend.self_watching:
            return WATCH_FALLBACK_TICK_S
        return None

    def wait_keys(
        self, keys: List[str], *, poll_s: Optional[float] = None, timeout_s: float = 60.0
    ) -> None:
        """Block until all keys exist (PyWren signals completion 'by the
        existence of this key').  Event-driven: woken by ``notify_put`` the
        moment a publisher on this handle lands a key; on a ``FileBackend``
        a publisher in *another process* is converted into the same wake by
        the backend's watch thread, so there is no polling on any built-in
        backend.  ``poll_s`` is kept for backward compatibility and forces
        a re-check tick; tick-bounded waits are counted in
        ``fallback_tick_waits``."""
        deadline = time.monotonic() + timeout_s
        tick = self.watch_tick_s(poll_s)
        pending = list(keys)
        seq: Optional[int] = None
        while True:
            if seq is None or tick is not None:
                # Full probe: first pass, tick mode (out-of-band writers),
                # or an event whose key set was unknown.  One batched
                # existence check per wake — a completion burst costs one
                # readdir, not one stat per still-pending key.
                seq = self.put_seq()
                present = self.backend.exists_many(pending)
            else:
                # Incremental: consume exactly the keys recent put events
                # named — O(1) bookkeeping per event, no backend probe.
                seq, landed = self.puts_since(seq)
                if landed is None:
                    present = self.backend.exists_many(pending)
                else:
                    present = landed
            pending = [k for k in pending if k not in present]
            if not pending:
                return
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"{len(pending)} keys still absent, e.g. {pending[:3]}")
            remaining = deadline - now
            if tick is None:
                self.wait_put(seq, remaining)
            else:
                self.fallback_tick_waits += 1
                self.wait_put(seq, min(tick, remaining))

    def iter_prefix(self, prefix: str, *, worker: str = "-") -> Iterator[Tuple[str, Any]]:
        for key in self.list(prefix, worker=worker):
            yield key, self.get(key, worker=worker)
