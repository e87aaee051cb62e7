"""Redis-semantics low-latency KV store: the coordination plane (a copy of
`repro.storage.kv_store`, so that the port imports nothing of the JAX
package; the log framing below is byte-compatible with the JAX package's,
so either package's file stores replay the other's logs).

The paper uses ElastiCache/Redis for (a) small synchronous put/gets (Fig 4),
(b) shuffle intermediates when S3 request throughput is the bottleneck
(Fig 5/6), and (c) parameter servers with server-side scripting for range
updates / flexible consistency (§3.3).

Reproduced semantics:
  * sharded keyspace (consistent hashing over N shards, each shard has its
    own request-throughput budget — the Fig 5/6 bottleneck);
  * atomic single-key ops: get/set/setnx/incr/cas/delete;
  * ``eval`` — server-side scripting analogue: apply a Python callable to a
    key's value *atomically under the shard lock* (Redis EVAL), used by the
    parameter server for in-place range updates (HOGWILD!);
  * lists (rpush/lrange) for queues, plus blocking ``blpop`` (Redis BLPOP).

Data plane (batching + per-shard notification):
  * **batched reads** — ``mget`` groups its keys by shard and serves each
    shard's group in one locked pass, charged as one amortized round-trip
    per *shard touched* (one request latency + summed transfer time) rather
    than one per key.  The Cloudburst/numpywren lesson applied to the
    coordination plane: parameter-server pulls and shuffle column reads
    cost O(shards) requests, not O(keys).
  * **batched writes** — ``mset`` (Redis MSET), pipelined ``rpush_many``,
    and ``eval_many`` (pipelined EVAL) mirror ``mget`` on the write side:
    keys are grouped by shard, each shard's group lands in one locked pass
    charged as one amortized round-trip (request latency + summed
    transfer), and each touched shard's sequence is bumped **exactly
    once** — a batch of N writes wakes each shard's watchers once, not N
    times.  Shuffle map-side fan-out, parameter-server pushes, and
    scheduler batch-submits ride these; ``mdel`` closes the lifecycle with
    the same per-shard accounting.
  * **per-shard watch conditions** — every mutating op (``set``/``setnx``/
    ``incr``/``cas``/``eval``/``rpush``/``delete``) bumps its shard's write
    sequence and broadcasts on the shard's condition.  Consumers snapshot
    ``shard_seq(key)``, check state, then block in ``wait_key`` until the
    shard's sequence advances (snapshot-then-wait: an in-process write can
    never be missed between the check and the wait).  ``blpop`` builds the
    Redis blocking-pop on top.  Scheduler queue waits and parameter-server
    pullers block here — per shard, woken only by writes that could matter
    to them — instead of riding a global poll tick.
  * wakeups from *this* class are in-process (it is an in-memory model);
    :class:`~repro_torch.storage.file_kv.FileKVStore` extends the identical
    contract across processes via per-shard seq files and a watch thread,
    so multi-process drivers get event-driven ``blpop``/``wait_key`` too.

Each op is charged virtual wire time and recorded per shard so benchmarks
can detect shard saturation exactly like the paper's sort experiment.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from .object_store import Ledger, OpRecord, _Endpoint
from .perf_model import REDIS_2017, StorageProfile

_TOMBSTONE = object()

# Sentinel an ``eval``/``eval_many`` update function may return to delete
# the key atomically instead of storing a value — the Redis-script idiom
# ``if ok then redis.call('DEL', key) end`` used by fenced lease releases:
# compare-epoch-then-delete must be one atomic step or a zombie's heartbeat
# could slip between the compare and the delete.  It must survive a pickle
# round-trip as the SAME object (update closures ship to repro-kvd, whose
# ``is DELETE`` check runs in another process), so it reduces to the
# module singleton rather than to a fresh anonymous ``object()``.
class _DeleteSentinel:
    __slots__ = ()

    def __repr__(self) -> str:
        return "DELETE"

    def __reduce__(self):
        return (_delete_sentinel, ())


def _delete_sentinel() -> "_DeleteSentinel":
    return DELETE


DELETE = _DeleteSentinel()


def kv_pure(fn):
    """Mark an eval function as PURE for the KV engines: it neither mutates
    its argument in place nor is its key's stored value mutated in place by
    any other writer.  A wire server may then hand the stored object to the
    function directly and return it as the pre-image without the defensive
    ``pickle`` deep-copy it otherwise pays per key (material on eval-heavy
    hot paths — lease records carry whole task specs).  Purity survives the
    wire: partials of a marked module function pickle by reference, so the
    marker is on the server-side unpickled function too."""
    fn.__kv_pure__ = True
    return fn


@dataclass
class ShardStats:
    ops: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    vtime_s: float = 0.0


# How many (seq, keys) touch records each shard remembers for keyed wakes —
# the KV mirror of ``_Backend._RECENT_PUTS`` in object_store.py.
_SHARD_RECENT = 512


class _Shard:
    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.lock = threading.RLock()
        # Watch condition shares the shard lock: writers notify while
        # already holding it, so notification adds no extra locking.
        self.cond = threading.Condition(self.lock)
        self.seq = 0  # monotonically increasing write sequence
        self.data: Dict[str, Any] = {}
        self.stats = ShardStats()
        # Ring of (seq, frozenset(keys) | None) per touch: lets keyed
        # waiters prove a wake named only other keys.  None = unknown
        # (virtual touch, cross-process file watch, ring overflow).
        self.recent: deque = deque(maxlen=_SHARD_RECENT)
        self.skipped_wakes = 0  # foreign-key wakes absorbed by wait_key

    def touch(self, keys: Optional[Iterable[str]] = None) -> None:
        """Record a write: bump the sequence, wake every shard watcher.
        ``keys`` names what the write touched so keyed waiters
        (:meth:`KVStore.wait_key`) can absorb wakes that provably do not
        concern them; ``None`` means unknown — treat as touching anything.
        Must be called with the shard lock held."""
        self.seq += 1
        self.recent.append((self.seq, None if keys is None else frozenset(keys)))
        self.cond.notify_all()


def _sizeof(value: Any) -> int:
    if isinstance(value, bytes):
        return len(value)
    if isinstance(value, str):
        return len(value.encode())
    if isinstance(value, (int, float)):
        return 8
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, (list, tuple)):
        return sum(_sizeof(v) for v in value) + 8
    if isinstance(value, dict):
        return sum(_sizeof(k) + _sizeof(v) for k, v in value.items()) + 8
    return 64  # opaque


# ---------------------------------------------------------------------------
# Record framing for append-only logs (shared by FileKVStore's per-shard
# logs and FileBackend's watch ledger).
#
# One *frame* is one commit: a length/CRC header followed by a pickled list
# of state-delta records.  The header makes torn tails self-detecting — a
# writer killed mid-append leaves either a short header, a short payload, or
# a CRC mismatch, and replay stops at the last whole frame (the committed
# prefix).  Records are state *deltas*, not operations, so replaying a log
# over the snapshot it was appended after reconstructs the exact state:
#
#   ("s", key, value)   set key to value          (set/incr/cas/eval/mset …)
#   ("d", key, None)    delete key                (delete/mdel/eval→DELETE)
#   ("a", key, [v, …])  extend key's list         (rpush/rpush_many)
#   ("p", key, n)       drop n items from the left of key's list (lpop/blpop)
#
# List ops get their own compact deltas because queues are the hottest keys:
# an rpush frame carries only the pushed values, never the whole list.
# ---------------------------------------------------------------------------

_FRAME_HDR = struct.Struct("<II")  # (payload length, crc32(payload))

# Wire-protocol buffer frames: bit 31 of the length field marks a
# frame whose payload is RAW BYTES, not a pickle — ndarray/blob payloads
# travel out-of-band from the pickled verb header so neither side copies
# them through the codec.  The bit is free: payload lengths are capped at
# MAX_FRAME_LEN (1 << 30) everywhere a frame is decoded, so a legitimate
# length never sets it.  Shard logs never use buffer frames; the flag
# lives here only because the wire protocol shares this header struct.
BUF_FLAG = 1 << 31
MAX_FRAME_LEN = 1 << 30  # the largest payload any frame decoder accepts

# Log files open with a fixed header naming the *generation* — bumped by
# every compaction, so a snapshot and the log it supersedes can never be
# replayed together (see file_kv.py's compaction protocol).
LOG_MAGIC = b"WKV1"
_LOG_HDR = struct.Struct("<4sQ")  # (magic, generation)
LOG_HEADER_SIZE = _LOG_HDR.size


def encode_log_header(generation: int) -> bytes:
    return _LOG_HDR.pack(LOG_MAGIC, generation)


def decode_log_header(buf: bytes) -> Optional[int]:
    """Generation from a log header, or None if short/corrupt."""
    if len(buf) < _LOG_HDR.size:
        return None
    magic, gen = _LOG_HDR.unpack_from(buf)
    if magic != LOG_MAGIC:
        return None
    return gen


def encode_frame(records: List[Tuple[str, str, Any]]) -> bytes:
    """Frame one commit's delta records: ``[len][crc32][pickle(records)]``."""
    payload = pickle.dumps(records, protocol=pickle.HIGHEST_PROTOCOL)
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(
    buf: bytes, start: int = 0
) -> Iterator[Tuple[List[Tuple[str, str, Any]], int]]:
    """Yield ``(records, end_offset)`` for every whole frame in ``buf``.

    Stops silently at the first torn frame (short header, short payload, or
    CRC mismatch): everything before it is the committed prefix, everything
    from it on is a crashed writer's garbage."""
    off = start
    n = len(buf)
    while off + _FRAME_HDR.size <= n:
        length, crc = _FRAME_HDR.unpack_from(buf, off)
        end = off + _FRAME_HDR.size + length
        if end > n:
            return  # torn payload
        payload = buf[off + _FRAME_HDR.size : end]
        if zlib.crc32(payload) != crc:
            return  # torn/corrupt frame
        yield pickle.loads(payload), end
        off = end


def apply_record(state: Dict[str, Any], rec: Tuple[str, str, Any]) -> None:
    """Apply one framed state-delta record to ``state`` (replay)."""
    op, key, val = rec
    if op == "s":
        state[key] = val
    elif op == "d":
        state.pop(key, None)
    elif op == "a":
        state.setdefault(key, []).extend(val)
    elif op == "p":
        lst = state.get(key)
        if lst:
            del lst[:val]
    else:  # pragma: no cover - forward-compat guard
        raise ValueError(f"unknown log record op {op!r}")


class KVStore(_Endpoint):
    """Sharded in-memory KV store with Redis-like atomic ops."""

    def __init__(
        self,
        num_shards: int = 1,
        profile: StorageProfile = REDIS_2017,
        ledger: Optional[Ledger] = None,
        *,
        charged: bool = True,
    ) -> None:
        if num_shards < 1:
            raise ValueError("num_shards >= 1")
        self.num_shards = num_shards
        self.profile = profile
        self.ledger = ledger or Ledger()
        # charged=False skips per-op accounting entirely — for engine-role
        # handles whose ledger nobody reads (the repro-kvd server charges
        # nothing; its CLIENTS charge, so the modeled ledger is theirs).
        self.charged = charged
        self._shards = [_Shard(i) for i in range(num_shards)]
        self._register_endpoint()

    # ---- sharding ------------------------------------------------------
    def shard_of(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.num_shards

    def _shard(self, key: str) -> _Shard:
        return self._shards[self.shard_of(key)]

    def _charge(
        self, shard: _Shard, worker: str, op: str, key: str, nbytes: int, write: bool
    ) -> None:
        if not self.charged:
            return
        vt = self.profile.write_time(nbytes) if write else self.profile.read_time(nbytes)
        shard.stats.ops += 1
        shard.stats.vtime_s += vt
        if write:
            shard.stats.bytes_in += nbytes
        else:
            shard.stats.bytes_out += nbytes
        self.ledger.record(OpRecord(worker, op, key, nbytes, vt, time.monotonic()))

    # ---- per-shard watch (notification plane) ---------------------------
    def shard_seq(self, key: str) -> int:
        """Snapshot the write sequence of ``key``'s shard; pass to
        :meth:`wait_key`.  Snapshot-then-check-then-wait makes an in-process
        write impossible to miss."""
        sh = self._shard(key)
        with sh.lock:
            return sh.seq

    def wait_key(self, key: str, last_seq: int, timeout_s: float) -> int:
        """Block until a write lands on ``key`` — not merely its shard —
        after the ``last_seq`` snapshot (or the timeout elapses); returns
        the current sequence.  Wakes are *keyed*: every touch records which
        keys it wrote (a ``puts_since``-style ring, mirroring the object
        store), and a wake whose key set provably excludes ``key`` is
        absorbed here instead of bouncing the caller into a futile
        predicate re-check.  A wake with unknown keys (virtual touch,
        cross-process file watch, ring overflow) conservatively returns.
        Callers still loop and re-check their own predicate, exactly like
        ``ObjectStore.wait_put``."""
        sh = self._shard(key)
        deadline = time.monotonic() + timeout_s
        with sh.lock:
            while True:
                if sh.seq != last_seq:
                    if self._touched(sh, key, last_seq):
                        return sh.seq
                    sh.skipped_wakes += 1
                    last_seq = sh.seq  # foreign-key wake: absorb and re-arm
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return sh.seq
                sh.cond.wait(remaining)

    @staticmethod
    def _touched(sh: _Shard, key: str, last_seq: int) -> bool:
        """True if any touch after ``last_seq`` may have written ``key``
        (named it, had unknown keys, or scrolled off the ring)."""
        recent = sh.recent
        if not recent or recent[0][0] > last_seq + 1:
            return True  # ring can't prove the wakes were foreign
        for seq, keys in recent:
            if seq <= last_seq:
                continue
            if keys is None or key in keys:
                return True
        return False

    def foreign_wake_skips(self) -> int:
        """How many shard wakes :meth:`wait_key` absorbed because the touch
        named only other keys — the keyed-wake win the dataplane tests pin."""
        return sum(sh.skipped_wakes for sh in self._shards)

    def notify_key(self, key: str) -> None:
        """Virtual touch: wake every watcher of ``key`` without writing
        (used by e.g. scheduler shutdown to unblock queue waiters)."""
        sh = self._shard(key)
        with sh.lock:
            sh.touch((key,))

    # ---- atomic single-key ops ------------------------------------------
    def set(self, key: str, value: Any, *, worker: str = "-") -> None:
        sh = self._shard(key)
        with sh.lock:
            sh.data[key] = value
            self._charge(sh, worker, "set", key, _sizeof(value), write=True)
            sh.touch((key,))

    def get(self, key: str, default: Any = None, *, worker: str = "-") -> Any:
        sh = self._shard(key)
        with sh.lock:
            value = sh.data.get(key, default)
            self._charge(sh, worker, "get", key, _sizeof(value), write=False)
            return value

    def mget(
        self, keys: List[str], default: Any = None, *, worker: str = "-"
    ) -> List[Any]:
        """Batched get (Redis MGET): values in ``keys`` order, ``default``
        for missing entries.  Keys are grouped by shard and each shard's
        group is served in one locked pass, charged as one amortized
        round-trip per shard touched (request latency + summed transfer) —
        not one per key."""
        by_shard: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self.shard_of(key), []).append(i)
        out: List[Any] = [default] * len(keys)
        for sidx, positions in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = 0
                for i in positions:
                    value = sh.data.get(keys[i], default)
                    out[i] = value
                    nbytes += _sizeof(value)
                # one amortized round-trip for the whole shard group
                self._charge(
                    sh, worker, "mget", f"[{len(positions)} keys@s{sidx}]",
                    nbytes, write=False,
                )
        return out

    def mset(self, mapping: Dict[str, Any], *, worker: str = "-") -> None:
        """Batched set (Redis MSET): the write-side mirror of :meth:`mget`.
        Keys are grouped by shard; each shard's group lands in one locked
        pass charged as one amortized round-trip (request latency + summed
        transfer), and the shard sequence is bumped exactly once — watchers
        wake once per touched shard, not once per key."""
        by_shard: Dict[int, List[str]] = {}
        for key in mapping:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = 0
                for key in group:
                    value = mapping[key]
                    sh.data[key] = value
                    nbytes += _sizeof(value)
                self._charge(
                    sh, worker, "mset", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )
                sh.touch(group)  # one wakeup per touched shard for the whole batch

    def setnx(self, key: str, value: Any, *, worker: str = "-") -> bool:
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "setnx", key, _sizeof(value), write=True)
            if key in sh.data:
                return False
            sh.data[key] = value
            sh.touch((key,))
            return True

    def incr(self, key: str, amount: float = 1, *, worker: str = "-") -> float:
        sh = self._shard(key)
        with sh.lock:
            new = sh.data.get(key, 0) + amount
            sh.data[key] = new
            self._charge(sh, worker, "incr", key, 8, write=True)
            sh.touch((key,))
            return new

    def cas(self, key: str, expect: Any, value: Any, *, worker: str = "-") -> bool:
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "cas", key, _sizeof(value), write=True)
            cur = sh.data.get(key, _TOMBSTONE)
            matched = (cur is not _TOMBSTONE and cur == expect) or (
                cur is _TOMBSTONE and expect is None
            )
            if matched:
                sh.data[key] = value
                sh.touch((key,))
                return True
            return False

    def delete(self, key: str, *, worker: str = "-") -> None:
        sh = self._shard(key)
        with sh.lock:
            sh.data.pop(key, None)
            self._charge(sh, worker, "del", key, 0, write=True)
            sh.touch((key,))

    def mdel(self, keys: List[str], *, worker: str = "-") -> int:
        """Batched delete: one amortized round-trip per shard touched (cf.
        :meth:`mget`).  Returns how many of the keys actually existed —
        job GC uses the count to settle advisory lease accounting."""
        by_shard: Dict[int, List[str]] = {}
        for key in keys:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        removed = 0
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                for key in group:
                    if sh.data.pop(key, _TOMBSTONE) is not _TOMBSTONE:
                        removed += 1
                self._charge(
                    sh, worker, "mdel", f"[{len(group)} keys@s{sidx}]", 0, write=True
                )
                sh.touch(group)
        return removed

    def exists(self, key: str, *, worker: str = "-") -> bool:
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "exists", key, 0, write=False)
            return key in sh.data

    def scan(self, prefix: str, *, worker: str = "-") -> List[str]:
        """All keys starting with ``prefix`` (Redis SCAN MATCH): one charged
        round-trip per shard — every shard must be visited, since hashing
        scatters a prefix across all of them.  Used by stateless scheduler
        handles to rebuild their lease-index caches from the KV (the KV is
        the source of truth; local heaps are hints)."""
        out: List[str] = []
        for sh in self._shards:
            with sh.lock:
                found = [k for k in sh.data if k.startswith(prefix)]
                self._charge(
                    sh, worker, "scan", f"[{prefix}*@s{sh.idx}]",
                    sum(len(k.encode()) for k in found), write=False,
                )
                out.extend(found)
        return sorted(out)

    # ---- server-side scripting (Redis EVAL analogue) ---------------------
    def eval(
        self,
        key: str,
        fn: Callable[[Any], Any],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Any:
        """Atomically ``data[key] = fn(data.get(key, default))`` under the
        shard lock; returns the new value.  This is the paper's 'existing
        support for server-side scripting … to implement features like range
        updates' — the parameter server's in-place gradient apply, and (with
        the :data:`DELETE` sentinel return) the scheduler's fenced
        compare-epoch-then-delete lease release."""
        sh = self._shard(key)
        with sh.lock:
            cur = sh.data.get(key, default)
            new = fn(cur)
            if new is DELETE:
                sh.data.pop(key, None)
                self._charge(sh, worker, "eval", key, 0, write=True)
                sh.touch((key,))
                return None
            sh.data[key] = new
            self._charge(sh, worker, "eval", key, _sizeof(new), write=True)
            sh.touch((key,))
            return new

    def eval_many(
        self,
        updates: Dict[str, Callable[[Any], Any]],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Dict[str, Any]:
        """Pipelined EVAL: apply ``updates[key]`` to each key atomically
        under its shard lock, grouped by shard — one amortized round-trip
        and **one** watcher wakeup per touched shard for the whole batch.
        Each update still runs atomically per key (HOGWILD! range-update
        semantics are unchanged); what's batched is the wire, not the
        locking.  Returns the new value per key."""
        by_shard: Dict[int, List[str]] = {}
        for key in updates:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        out: Dict[str, Any] = {}
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = 0
                for key in group:
                    new = updates[key](sh.data.get(key, default))
                    if new is DELETE:
                        sh.data.pop(key, None)
                        out[key] = None
                        continue
                    sh.data[key] = new
                    out[key] = new
                    nbytes += _sizeof(new)
                self._charge(
                    sh, worker, "meval", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )
                sh.touch(group)
        return out

    # ---- lists (queues) ---------------------------------------------------
    def rpush(self, key: str, *values: Any, worker: str = "-") -> int:
        sh = self._shard(key)
        with sh.lock:
            lst = sh.data.setdefault(key, [])
            lst.extend(values)
            self._charge(sh, worker, "rpush", key, sum(_sizeof(v) for v in values), write=True)
            sh.touch((key,))
            return len(lst)

    def rpush_nowait(self, key: str, *values: Any, worker: str = "-") -> None:
        """Advisory RPUSH: no return value and — on wire-backed stores — no
        round trip (the append rides a fire-and-forget frame and may be
        dropped by a reconnect window).  For telemetry-grade appends like
        duration samples, where losing one entry is benign but paying a
        blocking round trip per task is not.  In-process stores append
        synchronously; only the *guarantee* is weakened, never the
        ordering a single client observes."""
        self.rpush(key, *values, worker=worker)

    def rpush_many(
        self, pushes: Dict[str, List[Any]], *, worker: str = "-"
    ) -> Dict[str, int]:
        """Pipelined RPUSH across keys: group by shard, extend every list in
        one locked pass per shard, charge one amortized round-trip per shard
        and bump each touched shard's sequence exactly once — N queue
        appends wake each shard's blocked ``blpop``/``wait_key`` consumers
        once.  Returns the new length per key."""
        by_shard: Dict[int, List[str]] = {}
        for key in pushes:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        lengths: Dict[str, int] = {}
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = 0
                for key in group:
                    values = pushes[key]
                    lst = sh.data.setdefault(key, [])
                    lst.extend(values)
                    lengths[key] = len(lst)
                    nbytes += sum(_sizeof(v) for v in values)
                self._charge(
                    sh, worker, "mrpush", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )
                sh.touch(group)
        return lengths

    def lpop(self, key: str, *, worker: str = "-") -> Any:
        sh = self._shard(key)
        with sh.lock:
            lst = sh.data.get(key)
            value = lst.pop(0) if lst else None
            self._charge(sh, worker, "lpop", key, _sizeof(value), write=True)
            return value

    def lpop_n(self, key: str, max_n: int, *, worker: str = "-") -> List[Any]:
        """Pop up to ``max_n`` items off the left of ``key``'s list in ONE
        locked pass / one charged round-trip (Redis ``LPOP key count``).
        The queue-consumer mirror of ``rpush_many``: a worker leasing a
        batch pays one request, not one per task."""
        sh = self._shard(key)
        with sh.lock:
            lst = sh.data.get(key)
            out = list(lst[:max_n]) if lst else []
            if out:
                del lst[: len(out)]
            self._charge(
                sh, worker, "lpopn", key,
                sum(_sizeof(v) for v in out), write=True,
            )
            return out

    def blpop(self, key: str, timeout_s: float, *, worker: str = "-") -> Any:
        """Blocking left pop (Redis BLPOP): pop the head of ``key``'s list,
        waiting on the shard's watch condition until an element arrives or
        the timeout elapses (then ``None``).  No polling: a producer's
        ``rpush`` on the same shard wakes this directly."""
        deadline = time.monotonic() + timeout_s
        sh = self._shard(key)
        with sh.lock:
            while True:
                lst = sh.data.get(key)
                if lst:
                    value = lst.pop(0)
                    self._charge(sh, worker, "blpop", key, _sizeof(value), write=True)
                    return value
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                sh.cond.wait(remaining)

    def lrange(self, key: str, start: int = 0, stop: int = -1, *, worker: str = "-") -> List[Any]:
        sh = self._shard(key)
        with sh.lock:
            lst = list(sh.data.get(key, []))
            out = lst[start:] if stop == -1 else lst[start : stop + 1]
            self._charge(sh, worker, "lrange", key, sum(_sizeof(v) for v in out), write=False)
            return out

    def llen(self, key: str, *, worker: str = "-") -> int:
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "llen", key, 8, write=False)
            return len(sh.data.get(key, []))

    # ---- stats ------------------------------------------------------------
    def shard_stats(self) -> List[ShardStats]:
        return [sh.stats for sh in self._shards]

    def total_ops(self) -> int:
        return sum(sh.stats.ops for sh in self._shards)

    def hottest_shard_vtime(self) -> float:
        """Virtual busy-time of the most loaded shard — the sort benchmark's
        bottleneck signal (paper Fig 6: 'Redis I/O time increases by 42%')."""
        return max((sh.stats.vtime_s for sh in self._shards), default=0.0)
