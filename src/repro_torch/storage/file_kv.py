"""Cross-process KV store over a shared directory — log-structured (a copy
of `repro.storage.file_kv`: the same files, frames and locks, so a JAX
process and a torch process can share one root).

The in-memory :class:`~repro_torch.storage.kv_store.KVStore` models ElastiCache
for a single driver process.  A *multi-process* driver — the paper's "N
concurrent drivers are as elastic as the workers" end state — needs the
same Redis semantics reachable from every process, so this module gives the
KV a file substrate with the same public API and the same per-shard
accounting.  The substrate is **log-structured**: the whole-shard
``pickle.dump``-per-transaction engine (``engine="snapshot"``) pays
O(shard size) for every op; this one pays O(record):

  * **per-shard append-only logs** — every commit appends one framed record
    batch (:func:`~repro_torch.storage.kv_store.encode_frame`) to ``shard-N.log``
    under the shard's ``flock``.  A batched op (``mset``/``rpush_many``/
    ``eval_many``/``mdel``) is **one multi-record frame** — one disk append
    per shard touched, not N snapshot rewrites;
  * **replay-the-tail reads** — each process keeps a materialized snapshot
    of the shard keyed by ``(generation, log offset)``; a transaction that
    finds the log unchanged reuses it outright, one that finds it grown
    replays only the tail it hasn't seen.  Deltas (not operations) are
    logged, so replay is pure assignment — see ``apply_record``;
  * **the log file is the seq** — the log's stat signature *is* the shard's
    cross-process write sequence (no separate ``.seq`` file).  The same waiter-gated watcher
    (:class:`~repro_torch.storage.object_store._PollWatcher`, inotify-backed on
    Linux) watches log sizes directly and converts foreign appends into
    this process's shard-condition broadcasts, so ``blpop``/``wait_key``
    block event-driven across processes;
  * **compaction** — when a shard's log outgrows
    ``max(compact_min_bytes, compact_ratio × last snapshot size)``, the
    live state is rewritten as the generation-suffixed
    ``shard-N.snap.{G+1}`` (pickled ``(G+1, state)``, fsynced, atomic
    rename) and the log is replaced by a fresh one carrying G+1 in its
    header (the G snapshot is unlinked).  Every step is crash-safe: a
    reader pairs a log strictly with its own generation's snapshot, so a
    crash between the two renames leaves the new snapshot inert — the old
    log (and anything a live peer appends to it afterwards) keeps reading
    correctly, and the stale snapshot is overwritten by the next
    successful compaction;
  * **off-thread compaction** — the snapshot rewrite is O(shard
    size), so running it inline would stall the committing transaction
    (and, behind ``repro-kvd``, every client of that shard).  With
    ``compaction="thread"`` (the default) a commit that crosses the
    threshold only *flags* the shard; a per-store compactor thread then
    runs the rewrite in two phases.  Phase A holds **no locks**: it reads
    the log file, replays it over its generation's snapshot, and lands the
    ``(G+1, state)`` pickle in a private tmp file.  Phase B takes the
    normal shard transaction (thread lock + flock) and re-checks the
    generation fence — if a peer compacted meanwhile the plan is
    discarded — then renames the snapshot into place and installs a fresh
    G+1 log carrying the frames committed *during* phase A.  Commit-path
    cost is one flag write; the crash windows are the same two renames as
    before.  ``compaction="inline"`` keeps the inline rewrite for
    deterministic tests;
  * **crash safety at the record level** — a writer killed mid-append
    leaves a torn tail; length/CRC framing detects it, replay stops at the
    committed prefix, and the next writer truncates the garbage before
    appending (it holds the exclusive flock, so this is race-free).

Durability is a **policy**, not a constant (``fsync=``):

  ========== =========================================================
  ``auto``    (default) fsync per commit for control keys — any key
              under ``durable_prefixes`` (``sched/``) — batched for
              data-plane keys: control transitions survive a machine
              crash, bulk churn rides the page cache
  ``commit``  fsync after every commit
  ``batch``   fsync after every ``fsync_batch_n`` commits (group
              commit; also flushed at compaction and ``close``)
  ``never``   OS-buffered only
  ========== =========================================================

Note that *visibility* is independent of fsync — commits are in the page
cache the instant the flock drops, so other processes always see them;
the policy only decides what survives a machine (not process) crash.

The snapshot-per-transaction engine survives as ``engine="snapshot"``;
``engine="log"`` is the default.

Virtual-time charging is identical to the in-memory KV (same op names,
same per-shard amortization), so benchmarks and ledgers compare directly.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .kv_store import (
    DELETE,
    LOG_HEADER_SIZE,
    KVStore,
    _sizeof,
    apply_record,
    decode_log_header,
    encode_frame,
    encode_log_header,
    iter_frames,
)
from .object_store import Ledger, _PollWatcher
from .perf_model import REDIS_2017, StorageProfile

# Commit fsync modes an engine understands (derived from the store policy).
_SYNC, _LAZY, _NONE = "sync", "lazy", "none"


class _Txn:
    """One shard transaction: a mutable ``state`` dict plus the framed
    state-delta ``records`` that describe every mutation made to it.  The
    helpers mutate and record in one step so state and log can't drift."""

    __slots__ = ("state", "records")

    def __init__(self, state: Dict[str, Any]) -> None:
        self.state = state
        self.records: List[Tuple[str, str, Any]] = []

    def put(self, key: str, value: Any) -> None:
        self.state[key] = value
        self.records.append(("s", key, value))

    def drop(self, key: str) -> bool:
        existed = self.state.pop(key, _MISS) is not _MISS
        if existed:
            self.records.append(("d", key, None))
        return existed

    def extend(self, key: str, values: List[Any]) -> List[Any]:
        lst = self.state.setdefault(key, [])
        lst.extend(values)
        self.records.append(("a", key, list(values)))
        return lst

    def popleft(self, key: str) -> Any:
        """Pop the head, or the ``_MISS`` sentinel when the list is empty —
        a stored ``None`` is a real element and must round-trip (Redis LPOP
        nil vs. stored-empty distinction)."""
        lst = self.state.get(key)
        if not lst:
            return _MISS
        value = lst.pop(0)
        self.records.append(("p", key, 1))
        return value

    def popleft_n(self, key: str, max_n: int) -> List[Any]:
        lst = self.state.get(key)
        out = list(lst[:max_n]) if lst else []
        if out:
            del lst[: len(out)]
            self.records.append(("p", key, len(out)))
        return out


_MISS = object()


class _LogShard:
    """One shard's log-structured engine.  Every method runs under the
    shard's exclusive ``flock`` (the store guarantees it), so file mutations
    never race; the generation header makes cross-process cache validation
    exact (see module docstring for the protocol)."""

    def __init__(
        self,
        root: str,
        sidx: int,
        *,
        compact_min_bytes: int,
        compact_ratio: float,
        fsync_batch_n: int,
    ) -> None:
        self.log_path = os.path.join(root, f"shard-{sidx}.log")
        # Snapshots are GENERATION-SUFFIXED (shard-N.snap.G): recovery pairs
        # a log strictly with its own generation's snapshot, so a crash
        # between compaction's two renames leaves a gen-G+1 snapshot that is
        # simply ignored (and later overwritten) while the gen-G log — and
        # any frames a live peer appended to it after the crash — replays
        # over the gen-G snapshot with nothing lost.
        self.snap_base = os.path.join(root, f"shard-{sidx}.snap")
        self._compact_min_bytes = compact_min_bytes
        self._compact_ratio = compact_ratio
        self._fsync_batch_n = fsync_batch_n
        self._fd: Optional[int] = None
        self._ino = -1
        self._gen = 0
        self._state: Optional[Dict[str, Any]] = None
        self._valid_end = 0  # committed prefix: absolute offset of last whole frame
        self._file_size = 0  # actual size (== _valid_end unless the tail is torn)
        self._snap_bytes = 0
        self._pending_syncs = 0
        self.bytes_written = 0  # real bytes this process wrote to disk (bench metric)
        self.compact_wanted = False  # set by commit, consumed by the compactor

    # The log's stat signature is the cross-process write sequence.
    @property
    def watch_path(self) -> str:
        return self.log_path

    # ---- file plumbing --------------------------------------------------
    def _open_fd(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
        self._fd = os.open(self.log_path, os.O_RDWR)
        self._ino = os.fstat(self._fd).st_ino

    def _write_fresh_log(self, generation: int) -> None:
        """Install an empty log carrying ``generation`` via atomic rename
        (a log file is *always* whole: it either exists with a full header
        or not at all)."""
        tmp = f"{self.log_path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(encode_log_header(generation))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.log_path)
        self._open_fd()
        self._gen = generation
        self._valid_end = self._file_size = LOG_HEADER_SIZE
        self._pending_syncs = 0

    def _snap_path(self, generation: int) -> str:
        return f"{self.snap_base}.{generation}"

    def _read_snapshot(self, generation: int) -> Dict[str, Any]:
        """State at ``generation``'s compaction point.  Generation 0 has no
        snapshot by construction.  Absence of the file is legitimate (never
        compacted at this generation); any OTHER error is re-raised — a
        transient EMFILE/EIO treated as "empty" would rebuild wrong state
        and then commit deltas against it."""
        if generation == 0:
            self._snap_bytes = 0
            return {}
        try:
            with open(self._snap_path(generation), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            self._snap_bytes = 0
            return {}
        gen, state = pickle.loads(blob)
        if int(gen) != generation:  # pragma: no cover - naming guarantees it
            raise RuntimeError(
                f"snapshot {self._snap_path(generation)} carries gen {gen}"
            )
        self._snap_bytes = len(blob)
        return dict(state)

    def _latest_snapshot_gen(self) -> int:
        """Highest generation with a snapshot on disk (0 if none) — the
        fallback anchor when a log header is unreadable."""
        best = 0
        prefix = os.path.basename(self.snap_base) + "."
        try:
            names = os.listdir(os.path.dirname(self.snap_base))
        except OSError:
            return 0
        for name in names:
            if name.startswith(prefix):
                try:
                    best = max(best, int(name[len(prefix):]))
                except ValueError:
                    continue
        return best

    # ---- load / replay --------------------------------------------------
    def load(self) -> Dict[str, Any]:
        """Current shard state (must hold the flock).  Fast path: log inode
        and size unchanged → reuse the materialized snapshot; grown → replay
        only the tail; anything else (compaction by a peer, first touch,
        crash leftovers) → full reload."""
        try:
            pst = os.stat(self.log_path)
        except FileNotFoundError:
            return self._reload()
        if (
            self._state is not None
            and pst.st_ino == self._ino
            and self._file_size == self._valid_end  # no torn tail on record
        ):
            if pst.st_size == self._file_size:
                return self._state  # unchanged: reuse outright
            if pst.st_size > self._valid_end:
                self._replay_tail(pst.st_size)  # grown: replay only the tail
                return self._state
            # Shrunk: offsets can't be trusted — reload.
        # Note the cached-torn-tail case always reloads: size alone can't
        # distinguish "garbage still there" from "a peer truncated it and
        # committed exactly as many bytes" — trusting the stale offsets
        # there would let our next commit ftruncate a peer's frame away.
        return self._reload()

    def load_fast(self) -> Dict[str, Any]:
        """:meth:`load` for an *exclusive* store: no other process writes
        this log, so a clean materialized state needs no stat round-trip.
        Falls back to the full load on first touch, after a failed commit
        (invalidate), or while a torn tail is on record."""
        if self._state is not None and self._file_size == self._valid_end:
            return self._state
        return self.load()

    def _replay_tail(self, size: int) -> None:
        tail = os.pread(self._fd, size - self._valid_end, self._valid_end)
        end = 0
        for records, end in iter_frames(tail):
            for rec in records:
                apply_record(self._state, rec)
        self._valid_end += end
        self._file_size = size  # > _valid_end iff the tail is torn

    def _reload(self) -> Dict[str, Any]:
        try:
            with open(self.log_path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            buf = None
        log_gen = decode_log_header(buf) if buf is not None else None
        if log_gen is None:
            # Log missing or header unreadable (external truncation; our own
            # log creation is atomic).  Anchor on the newest snapshot — the
            # log's post-snapshot frames are unrecoverable without a header,
            # but the snapshot state is — and install a fresh log there.
            gen = self._latest_snapshot_gen()
            self._state = self._read_snapshot(gen)
            self._write_fresh_log(gen)
            return self._state
        # The log's own generation names its snapshot: a crashed compaction
        # may have left a NEWER snapshot (gen+1) behind, but this log — and
        # anything a live peer appended to it since — pairs with gen's, so
        # nothing committed is ever discarded.  The stale gen+1 snapshot is
        # overwritten by the next successful compaction.
        self._state = self._read_snapshot(log_gen)
        self._open_fd()
        self._gen = log_gen
        # Replay from the buffer already in hand (one read, not a second
        # pread of the same bytes through the fd).
        end = LOG_HEADER_SIZE
        for records, end in iter_frames(buf, LOG_HEADER_SIZE):
            for rec in records:
                apply_record(self._state, rec)
        self._valid_end = end
        self._file_size = len(buf)
        return self._state

    # ---- commit / compaction -------------------------------------------
    def commit(self, state: Dict[str, Any], records: List[tuple], mode: str) -> None:
        """Append one frame for this transaction's records (must hold the
        flock; ``state`` is the dict ``load`` returned, already mutated)."""
        if self._file_size > self._valid_end:
            # A crashed writer's torn tail sits after the committed prefix;
            # drop it so our frame lands contiguously (flock makes this safe).
            os.ftruncate(self._fd, self._valid_end)
            self._file_size = self._valid_end
        frame = encode_frame(records)
        written = 0
        while written < len(frame):
            # pwrite may write short (ENOSPC mid-frame returns a count, not
            # an exception): advancing offsets on a short write would record
            # a phantom commit that replay drops at the torn frame.
            n = os.pwrite(self._fd, frame[written:], self._valid_end + written)
            if n <= 0:
                raise OSError(f"short log append: {written}/{len(frame)} bytes")
            written += n
        self._valid_end += len(frame)
        self._file_size = self._valid_end
        self.bytes_written += len(frame)
        self._pending_syncs += 1
        if mode == _SYNC or (
            mode == _LAZY and self._pending_syncs >= self._fsync_batch_n
        ):
            self.sync()
        log_bytes = self._valid_end - LOG_HEADER_SIZE
        if log_bytes >= max(
            self._compact_min_bytes, self._compact_ratio * self._snap_bytes
        ):
            # Only flag: the snapshot rewrite is O(shard size) and must not
            # run inside the commit path — the store decides whether to run
            # it inline (tests) or hand it to the compactor thread.
            self.compact_wanted = True

    def sync(self) -> None:
        if self._fd is not None and self._pending_syncs:
            os.fsync(self._fd)
            self._pending_syncs = 0

    def _publish_snapshot(self, state: Dict[str, Any]) -> int:
        """Step 1 of compaction: land ``(gen+1, state)`` as the gen+1
        snapshot via fsync + atomic rename.  Split out so crash tests can
        stop here — until step 2 swaps the log, the gen+1 snapshot is inert
        (readers pair the gen-G log with the gen-G snapshot), so the state
        must read back identically, including later appends by live
        peers."""
        new_gen = self._gen + 1
        blob = pickle.dumps((new_gen, state), protocol=pickle.HIGHEST_PROTOCOL)
        tmp = f"{self.snap_base}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path(new_gen))
        self._snap_bytes = len(blob)
        self.bytes_written += len(blob)
        return new_gen

    def _compact(self, state: Dict[str, Any]) -> None:
        """Rewrite live state as a snapshot and truncate the log (both via
        atomic rename).  Crash-safe: until step 2 installs the gen+1 log,
        the gen+1 snapshot is ignored by every reader; after it, the old
        generation's snapshot is garbage and is unlinked best-effort."""
        old_gen = self._gen
        new_gen = self._publish_snapshot(state)
        self._write_fresh_log(new_gen)
        self.compact_wanted = False
        if old_gen:
            try:
                os.unlink(self._snap_path(old_gen))
            except OSError:
                pass

    # ---- two-phase off-thread compaction --------------------------------
    def _peek_snapshot(self, generation: int) -> Optional[Dict[str, Any]]:
        """Read-only :meth:`_read_snapshot`: no engine bookkeeping is
        touched, corruption returns ``None`` (abort the plan) instead of
        raising — the compactor runs without locks and must never poison
        the engine's own state."""
        if generation == 0:
            return {}
        try:
            with open(self._snap_path(generation), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return {}
        except OSError:
            return None
        try:
            gen, state = pickle.loads(blob)
        except Exception:
            return None
        if int(gen) != generation:
            return None
        return dict(state)

    def plan_compaction(self) -> Optional[tuple]:
        """Phase A — runs on the compactor thread with NO locks held.  Reads
        the log file as any crash-recovery reader would (header names the
        snapshot, replay whole frames, stop at a torn tail), pickles the
        folded state, and lands it fsynced in a *private* tmp file.
        Concurrent commits only append, so the replayed prefix is a
        consistent point-in-time state; anything committed after it rides
        into the next generation's log as the tail (phase B).  Returns the
        plan ``(gen, end_offset, tmp_path, blob_len)`` or ``None`` when
        there is nothing to do / a peer compacted first."""
        gen = self._gen
        try:
            with open(self.log_path, "rb") as f:
                buf = f.read()
        except OSError:
            return None
        if decode_log_header(buf) != gen:
            return None  # a peer swapped the log since we were flagged
        state = self._peek_snapshot(gen)
        if state is None:
            return None
        end = LOG_HEADER_SIZE
        for records, end in iter_frames(buf, LOG_HEADER_SIZE):
            for rec in records:
                apply_record(state, rec)
        if end <= LOG_HEADER_SIZE:
            return None  # empty log: nothing to fold in
        blob = pickle.dumps((gen + 1, state), protocol=pickle.HIGHEST_PROTOCOL)
        tmp = f"{self.snap_base}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        return (gen, end, tmp, len(blob))

    def finish_compaction(self, plan: tuple) -> bool:
        """Phase B — must hold the shard transaction (thread lock + flock,
        state freshly loaded).  Re-checks the generation fence: if this
        engine is no longer at the plan's generation (a peer compacted, the
        log was replaced) the plan is stale and is discarded unapplied.
        Otherwise the tmp snapshot renames into place and a fresh gen+1 log
        is installed carrying the frames committed after the plan's replay
        point — the same two atomic renames (and crash windows) as
        :meth:`_compact`."""
        gen, end, tmp, blob_len = plan
        if self._gen != gen or end > self._valid_end:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        new_gen = gen + 1
        os.replace(tmp, self._snap_path(new_gen))
        self._snap_bytes = blob_len
        self.bytes_written += blob_len
        # Frames committed while phase A ran carry over into the new log.
        tail = b""
        if self._valid_end > end:
            tail = os.pread(self._fd, self._valid_end - end, end)
        ltmp = f"{self.log_path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(ltmp, "wb") as f:
            f.write(encode_log_header(new_gen))
            if tail:
                f.write(tail)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ltmp, self.log_path)
        self._open_fd()
        self._gen = new_gen
        self._valid_end = self._file_size = LOG_HEADER_SIZE + len(tail)
        self.bytes_written += len(tail)
        self._pending_syncs = 0
        self.compact_wanted = False
        if gen:
            try:
                os.unlink(self._snap_path(gen))
            except OSError:
                pass
        return True

    def invalidate(self) -> None:
        """Drop the materialized snapshot (a transaction body raised after
        mutating it): the next load replays from disk."""
        self._state = None

    def close(self) -> None:
        if self._fd is not None:
            self.sync()
            os.close(self._fd)
            self._fd = None
        self._state = None  # a reused handle reloads (and reopens) cleanly


class _SnapshotShard:
    """The snapshot engine: whole-shard pickle per transaction, per-shard seq
    file appended under the flock.  O(shard size) per op — kept only so the
    microbench can price the log engine against it (``engine="snapshot"``)."""

    def __init__(self, root: str, sidx: int, *, fsync_batch_n: int) -> None:
        self.data_path = os.path.join(root, f"shard-{sidx}.pkl")
        self.seq_path = os.path.join(root, f"shard-{sidx}.seq")
        self._fsync_batch_n = fsync_batch_n
        self._snap: Optional[Tuple[int, Dict[str, Any]]] = None
        self._pending_syncs = 0
        self.bytes_written = 0  # real bytes this process wrote to disk (bench metric)

    @property
    def watch_path(self) -> str:
        return self.seq_path

    def load(self) -> Dict[str, Any]:
        try:
            size = os.path.getsize(self.seq_path)
        except OSError:
            size = 0
        if self._snap is not None and self._snap[0] == size:
            return self._snap[1]
        try:
            with open(self.data_path, "rb") as f:
                state = pickle.load(f)
        except (OSError, EOFError):
            state = {}
        self._snap = (size, state)
        return state

    def load_fast(self) -> Dict[str, Any]:
        return self.load()  # snapshot engine: no exclusive fast path

    def commit(self, state: Dict[str, Any], records: List[tuple], mode: str) -> None:
        tmp = f"{self.data_path}.tmp.{os.getpid()}.{threading.get_ident()}"
        self._pending_syncs += 1
        durable = mode == _SYNC or (
            mode == _LAZY and self._pending_syncs >= self._fsync_batch_n
        )
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            if durable:
                f.flush()
                os.fsync(f.fileno())
                self._pending_syncs = 0
            self.bytes_written += f.tell() + 1  # whole snapshot + the seq byte
        os.replace(tmp, self.data_path)
        fd = os.open(self.seq_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, b"x")
        finally:
            os.close(fd)
        try:
            size = os.path.getsize(self.seq_path)
        except OSError:
            size = 0
        self._snap = (size, state)

    def sync(self) -> None:
        self._pending_syncs = 0

    def invalidate(self) -> None:
        self._snap = None

    def close(self) -> None:
        pass


class FileKVStore(KVStore):
    """Sharded KV store over a shared directory (cross-process Redis model).

    Same public API and notification contract as :class:`KVStore`; see the
    module docstring for the log-structured substrate and the durability
    policy.  Construct one handle per process over the same ``root`` — all
    handles see one keyspace and wake each other's waiters."""

    def __init__(
        self,
        root: str,
        num_shards: int = 1,
        profile: StorageProfile = REDIS_2017,
        ledger: Optional[Ledger] = None,
        *,
        engine: str = "log",
        fsync: str = "auto",
        durable_prefixes: Tuple[str, ...] = ("sched/",),
        fsync_batch_n: int = 64,
        compact_min_bytes: int = 64 * 1024,
        compact_ratio: float = 4.0,
        compaction: str = "thread",
        exclusive: bool = False,
        charged: bool = True,
    ) -> None:
        if engine not in ("log", "snapshot"):
            raise ValueError(f"engine must be 'log' or 'snapshot', got {engine!r}")
        if fsync == "always":
            fsync = "commit"  # FileBackend's name for the same policy
        if fsync not in ("auto", "commit", "batch", "never"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        if compaction not in ("thread", "inline"):
            raise ValueError(f"compaction must be 'thread' or 'inline', got {compaction!r}")
        super().__init__(
            num_shards=num_shards, profile=profile, ledger=ledger, charged=charged
        )
        self.root = os.path.abspath(root)
        self.engine = engine
        self.fsync = fsync
        # Exclusive mode: this handle is the directory's SOLE writer and
        # reader (the repro-kvd server owning its data dir, like Redis its
        # AOF).  Transactions then skip the cross-process flock and the
        # per-op stat validation — shard thread locks and the materialized
        # state are authoritative — which is where the wire tier's speed
        # over the shared-disk substrate comes from.  Crash safety is
        # unchanged: every commit is still one framed append.
        self.exclusive = exclusive
        self.durable_prefixes = tuple(durable_prefixes)
        os.makedirs(self.root, exist_ok=True)
        if engine == "log":
            self._engines = [
                _LogShard(
                    self.root,
                    i,
                    compact_min_bytes=compact_min_bytes,
                    compact_ratio=compact_ratio,
                    fsync_batch_n=fsync_batch_n,
                )
                for i in range(num_shards)
            ]
        else:
            self._engines = [
                _SnapshotShard(self.root, i, fsync_batch_n=fsync_batch_n)
                for i in range(num_shards)
            ]
        self._lock_fds: List[Optional[int]] = [None] * num_shards
        self._fd_guard = threading.Lock()
        self._watcher: Optional[_PollWatcher] = None
        self._watch_guard = threading.Lock()
        # Off-thread compaction: flagged shards queue here; one lazy daemon
        # thread per store drains the queue (see _LogShard.plan_compaction).
        self.compaction = compaction
        self._compact_pending: set = set()
        self._compact_cond = threading.Condition()
        self._compactor: Optional[threading.Thread] = None
        self._compact_busy = False
        self._closing = False

    def _endpoint_spec(self):
        # Cross-process pickling: a closure capturing this handle reconnects
        # over the same directory in a foreign process (one shared handle per
        # (kind, root) there — see object_store._Endpoint), which is what
        # lets an adopting driver's workers run a dead driver's registered
        # task functions.
        return {
            "kind": "file_kv",
            "root": self.root,
            "num_shards": self.num_shards,
            "engine": self.engine,
            "fsync": self.fsync,
        }

    # ---- durability policy ----------------------------------------------
    def _commit_mode(self, records: List[tuple]) -> str:
        if self.fsync == "commit":
            return _SYNC
        if self.fsync == "never":
            return _NONE
        if self.fsync == "batch":
            return _LAZY
        # auto: control keys fsync per commit, data-plane keys batch
        for _op, key, _val in records:
            if key.startswith(self.durable_prefixes):
                return _SYNC
        return _LAZY

    # ---- locks -----------------------------------------------------------
    def _lock_fd(self, sidx: int) -> int:
        fd = self._lock_fds[sidx]
        if fd is None:
            with self._fd_guard:
                fd = self._lock_fds[sidx]
                if fd is None:
                    fd = os.open(
                        os.path.join(self.root, f"shard-{sidx}.lock"),
                        os.O_WRONLY | os.O_CREAT,
                        0o644,
                    )
                    self._lock_fds[sidx] = fd
        return fd

    # ---- transactions ----------------------------------------------------
    def _txn(self, sidx: int):
        """Context manager: shard thread lock + cross-process flock around a
        load → mutate → (append frame if dirty) → in-process notify cycle."""
        store = self

        class _Ctx:
            def __enter__(self) -> _Txn:
                self._sh = store._shards[sidx]
                self._sh.lock.acquire()
                eng = store._engines[sidx]
                if store.exclusive:
                    # Sole-owner fast path: no flock, no stat — the shard
                    # thread lock is the whole mutual exclusion.
                    try:
                        self._txn = _Txn(eng.load_fast())
                    except BaseException:
                        self._sh.lock.release()
                        raise
                    return self._txn
                fd = store._lock_fd(sidx)
                # reprolint: disable=LOCK001(thread-lock-then-flock is the txn protocol's fixed lock order; every shard txn takes both)
                fcntl.flock(fd, fcntl.LOCK_EX)
                try:
                    self._txn = _Txn(eng.load())
                except BaseException:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                    self._sh.lock.release()
                    raise
                return self._txn

            def __exit__(self, *exc) -> bool:
                eng = store._engines[sidx]
                dirty = bool(self._txn.records)
                committed = False
                try:
                    if exc[0] is None and dirty:
                        try:
                            eng.commit(
                                self._txn.state,
                                self._txn.records,
                                store._commit_mode(self._txn.records),
                            )
                            committed = True
                            if getattr(eng, "compact_wanted", False):
                                if store.compaction == "inline":
                                    # Still under the flock: safe to rewrite.
                                    eng._compact(self._txn.state)
                                else:
                                    store._request_compact(sidx)
                        except BaseException:
                            # The append failed (unpicklable value, ENOSPC,
                            # …): the materialized state was already mutated
                            # and now diverges from disk — drop it, or every
                            # later read in this process would return the
                            # phantom write no other process can see.
                            eng.invalidate()
                            raise
                    elif dirty:
                        # The body raised after mutating the materialized
                        # state: it no longer matches disk — drop it.
                        eng.invalidate()
                finally:
                    if not store.exclusive:
                        fcntl.flock(store._lock_fd(sidx), fcntl.LOCK_UN)
                    if committed:
                        # Keyed wake: the frame's records name exactly the
                        # keys this commit touched.
                        self._sh.touch({k for _op, k, _v in self._txn.records})
                    self._sh.lock.release()
                return False

        return _Ctx()

    # ---- cross-process watch --------------------------------------------
    def _ensure_watcher(self) -> _PollWatcher:
        with self._watch_guard:
            if self._watcher is None:
                paths = [eng.watch_path for eng in self._engines]

                def _on_change(changed: List[int]) -> None:
                    for sidx in changed:
                        sh = self._shards[sidx]
                        with sh.lock:
                            sh.touch()

                self._watcher = _PollWatcher(paths, _on_change)
            return self._watcher

    # ---- off-thread compaction ------------------------------------------
    def _request_compact(self, sidx: int) -> None:
        """Queue a shard for the compactor thread (idempotent: a shard is
        queued at most once; requests while it runs re-queue it)."""
        with self._compact_cond:
            if self._closing:
                return
            self._compact_pending.add(sidx)
            if self._compactor is None:
                self._compactor = threading.Thread(
                    target=self._compact_loop, name="filekv-compactor", daemon=True
                )
                self._compactor.start()
            self._compact_cond.notify_all()

    def _compact_loop(self) -> None:
        while True:
            with self._compact_cond:
                while not self._compact_pending and not self._closing:
                    self._compact_cond.wait()
                if not self._compact_pending:  # closing and drained
                    return
                sidx = self._compact_pending.pop()
                self._compact_busy = True
            try:
                self._compact_shard(sidx)
            except Exception:
                # A failed rewrite must never kill the compactor: the flag
                # re-queues the shard at its next threshold-crossing commit.
                self._engines[sidx].invalidate()
            finally:
                with self._compact_cond:
                    self._compact_busy = False
                    self._compact_cond.notify_all()

    def _compact_shard(self, sidx: int) -> None:
        eng = self._engines[sidx]
        plan = eng.plan_compaction()  # phase A: no locks
        if plan is None:
            # Nothing to fold (or a peer got there first): drop the flag so
            # sub-threshold commits stop re-queueing the shard.
            eng.compact_wanted = False
            return
        with self._txn(sidx):  # phase B: under the normal shard transaction
            eng.finish_compaction(plan)

    def compact_now(self, timeout_s: float = 30.0) -> None:
        """Drain the compactor: block until every queued request has run
        (durability/test barrier — commits flag shards asynchronously, so a
        size assertion needs this fence first)."""
        for sidx, eng in enumerate(self._engines):
            if getattr(eng, "compact_wanted", False):
                self._request_compact(sidx)
        deadline = time.monotonic() + timeout_s
        with self._compact_cond:
            while self._compact_pending or self._compact_busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("compaction drain timed out")
                self._compact_cond.wait(remaining)

    def _stop_compactor(self) -> None:
        with self._compact_cond:
            self._closing = True
            self._compact_cond.notify_all()
            thread = self._compactor
        if thread is not None:
            thread.join(timeout=30.0)
        with self._compact_cond:
            self._compactor = None
            self._closing = False  # a reused handle may compact again

    def disk_bytes_written(self) -> int:
        """Real bytes this handle wrote to disk (logs + snapshots, or
        whole-shard pickles for the snapshot engine).  The deterministic
        half of the engine comparison: wall time varies with the host's
        I/O weather, write volume does not."""
        return sum(eng.bytes_written for eng in self._engines)

    def sync(self) -> None:
        """Flush every shard's pending lazy fsyncs (durability barrier)."""
        for sidx in range(self.num_shards):
            sh = self._shards[sidx]
            with sh.lock:
                if self.exclusive:
                    self._engines[sidx].sync()
                    continue
                fd = self._lock_fd(sidx)
                # reprolint: disable=LOCK001(durability barrier takes the same thread-lock-then-flock order as _txn)
                fcntl.flock(fd, fcntl.LOCK_EX)
                try:
                    self._engines[sidx].sync()
                finally:
                    fcntl.flock(fd, fcntl.LOCK_UN)

    def close(self) -> None:
        """Drain the compactor, stop the watch thread, flush lazy fsyncs,
        release fds (tests)."""
        self._stop_compactor()
        with self._watch_guard:
            if self._watcher is not None:
                self._watcher.close()
                self._watcher = None
        for eng in self._engines:
            eng.close()
        with self._fd_guard:
            for i, fd in enumerate(self._lock_fds):
                if fd is not None:
                    os.close(fd)
                    self._lock_fds[i] = None

    def wait_key(self, key: str, last_seq: int, timeout_s: float) -> int:
        """Blocking shard watch, cross-process: while registered, the
        watcher converts foreign log growth into shard-condition
        broadcasts, so the inherited condition wait needs no tick."""
        watcher = self._ensure_watcher()
        watcher.add_waiter()
        try:
            return super().wait_key(key, last_seq, timeout_s)
        finally:
            watcher.remove_waiter()

    # ---- atomic single-key ops ------------------------------------------
    def set(self, key: str, value: Any, *, worker: str = "-") -> None:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            t.put(key, value)
            self._charge(self._shards[sidx], worker, "set", key, _sizeof(value), write=True)

    def get(self, key: str, default: Any = None, *, worker: str = "-") -> Any:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            value = t.state.get(key, default)
            self._charge(self._shards[sidx], worker, "get", key, _sizeof(value), write=False)
            return value

    def mget(
        self, keys: List[str], default: Any = None, *, worker: str = "-"
    ) -> List[Any]:
        by_shard: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self.shard_of(key), []).append(i)
        out: List[Any] = [default] * len(keys)
        for sidx, positions in by_shard.items():
            with self._txn(sidx) as t:
                nbytes = 0
                for i in positions:
                    value = t.state.get(keys[i], default)
                    out[i] = value
                    nbytes += _sizeof(value)
                self._charge(
                    self._shards[sidx], worker, "mget",
                    f"[{len(positions)} keys@s{sidx}]", nbytes, write=False,
                )
        return out

    def mset(self, mapping: Dict[str, Any], *, worker: str = "-") -> None:
        by_shard: Dict[int, List[str]] = {}
        for key in mapping:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        for sidx, group in by_shard.items():
            with self._txn(sidx) as t:
                nbytes = 0
                for key in group:
                    t.put(key, mapping[key])
                    nbytes += _sizeof(mapping[key])
                self._charge(
                    self._shards[sidx], worker, "mset",
                    f"[{len(group)} keys@s{sidx}]", nbytes, write=True,
                )

    def setnx(self, key: str, value: Any, *, worker: str = "-") -> bool:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            self._charge(self._shards[sidx], worker, "setnx", key, _sizeof(value), write=True)
            if key in t.state:
                return False
            t.put(key, value)
            return True

    def incr(self, key: str, amount: float = 1, *, worker: str = "-") -> float:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            new = t.state.get(key, 0) + amount
            t.put(key, new)
            self._charge(self._shards[sidx], worker, "incr", key, 8, write=True)
            return new

    def cas(self, key: str, expect: Any, value: Any, *, worker: str = "-") -> bool:
        sentinel = object()
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            self._charge(self._shards[sidx], worker, "cas", key, _sizeof(value), write=True)
            cur = t.state.get(key, sentinel)
            matched = (cur is not sentinel and cur == expect) or (
                cur is sentinel and expect is None
            )
            if matched:
                t.put(key, value)
                return True
            return False

    def delete(self, key: str, *, worker: str = "-") -> None:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            t.drop(key)
            self._charge(self._shards[sidx], worker, "del", key, 0, write=True)

    def mdel(self, keys: List[str], *, worker: str = "-") -> int:
        by_shard: Dict[int, List[str]] = {}
        for key in keys:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        removed = 0
        for sidx, group in by_shard.items():
            with self._txn(sidx) as t:
                for key in group:
                    if t.drop(key):
                        removed += 1
                self._charge(
                    self._shards[sidx], worker, "mdel",
                    f"[{len(group)} keys@s{sidx}]", 0, write=True,
                )
        return removed

    def exists(self, key: str, *, worker: str = "-") -> bool:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            self._charge(self._shards[sidx], worker, "exists", key, 0, write=False)
            return key in t.state

    def scan(self, prefix: str, *, worker: str = "-") -> List[str]:
        out: List[str] = []
        for sidx in range(self.num_shards):
            with self._txn(sidx) as t:
                found = [k for k in t.state if k.startswith(prefix)]
                self._charge(
                    self._shards[sidx], worker, "scan", f"[{prefix}*@s{sidx}]",
                    sum(len(k.encode()) for k in found), write=False,
                )
                out.extend(found)
        return sorted(out)

    # ---- server-side scripting ------------------------------------------
    def eval(
        self,
        key: str,
        fn: Callable[[Any], Any],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Any:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            new = fn(t.state.get(key, default))
            if new is DELETE:
                t.drop(key)
                self._charge(self._shards[sidx], worker, "eval", key, 0, write=True)
                return None
            t.put(key, new)
            self._charge(self._shards[sidx], worker, "eval", key, _sizeof(new), write=True)
            return new

    def eval_many(
        self,
        updates: Dict[str, Callable[[Any], Any]],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Dict[str, Any]:
        by_shard: Dict[int, List[str]] = {}
        for key in updates:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        out: Dict[str, Any] = {}
        for sidx, group in by_shard.items():
            with self._txn(sidx) as t:
                nbytes = 0
                for key in group:
                    new = updates[key](t.state.get(key, default))
                    if new is DELETE:
                        t.drop(key)
                        out[key] = None
                        continue
                    t.put(key, new)
                    out[key] = new
                    nbytes += _sizeof(new)
                self._charge(
                    self._shards[sidx], worker, "meval",
                    f"[{len(group)} keys@s{sidx}]", nbytes, write=True,
                )
        return out

    # ---- lists (queues) --------------------------------------------------
    def rpush(self, key: str, *values: Any, worker: str = "-") -> int:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            lst = t.extend(key, list(values))
            self._charge(
                self._shards[sidx], worker, "rpush", key,
                sum(_sizeof(v) for v in values), write=True,
            )
            return len(lst)

    def rpush_many(
        self, pushes: Dict[str, List[Any]], *, worker: str = "-"
    ) -> Dict[str, int]:
        by_shard: Dict[int, List[str]] = {}
        for key in pushes:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        lengths: Dict[str, int] = {}
        for sidx, group in by_shard.items():
            with self._txn(sidx) as t:
                nbytes = 0
                for key in group:
                    values = pushes[key]
                    lst = t.extend(key, list(values))
                    lengths[key] = len(lst)
                    nbytes += sum(_sizeof(v) for v in values)
                self._charge(
                    self._shards[sidx], worker, "mrpush",
                    f"[{len(group)} keys@s{sidx}]", nbytes, write=True,
                )
        return lengths

    def lpop(self, key: str, *, worker: str = "-") -> Any:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            popped = t.popleft(key)
            value = None if popped is _MISS else popped
            self._charge(self._shards[sidx], worker, "lpop", key, _sizeof(value), write=True)
            return value

    def lpop_n(self, key: str, max_n: int, *, worker: str = "-") -> List[Any]:
        """Batched left pop: one flock transaction, one framed ``("p", key,
        n)`` record — a worker leasing a batch pays one disk append."""
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            out = t.popleft_n(key, max_n)
            self._charge(
                self._shards[sidx], worker, "lpopn", key,
                sum(_sizeof(v) for v in out), write=True,
            )
            return out

    def blpop(self, key: str, timeout_s: float, *, worker: str = "-") -> Any:
        """Blocking left pop across processes.  The flock is held only for
        each pop *attempt*, never across the wait — otherwise a waiting
        consumer would lock every producer out of the shard.  Between
        attempts the consumer blocks on the shard condition; a local push
        notifies it directly, a remote push grows the shard log and the
        watcher relays the notify."""
        deadline = time.monotonic() + timeout_s
        sidx = self.shard_of(key)
        sh = self._shards[sidx]
        watcher = self._ensure_watcher()
        watcher.add_waiter()
        try:
            while True:
                with self._txn(sidx) as t:
                    popped = t.popleft(key)
                    if popped is not _MISS:
                        # a stored None is a real element: pop and return it
                        self._charge(sh, worker, "blpop", key, _sizeof(popped), write=True)
                        return popped
                    seq = sh.seq
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                with sh.lock:
                    if sh.seq == seq:
                        sh.cond.wait(remaining)
        finally:
            watcher.remove_waiter()

    def lrange(self, key: str, start: int = 0, stop: int = -1, *, worker: str = "-") -> List[Any]:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            lst = list(t.state.get(key, []))
            out = lst[start:] if stop == -1 else lst[start : stop + 1]
            self._charge(
                self._shards[sidx], worker, "lrange", key,
                sum(_sizeof(v) for v in out), write=False,
            )
            return out

    def llen(self, key: str, *, worker: str = "-") -> int:
        sidx = self.shard_of(key)
        with self._txn(sidx) as t:
            self._charge(self._shards[sidx], worker, "llen", key, 8, write=False)
            return len(t.state.get(key, []))
