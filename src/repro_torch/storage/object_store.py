"""S3-semantics object store, in memory (port of the in-memory parts of
`repro.storage.object_store`, copied so that the port imports nothing of
the JAX package; the file and net backends come with a later slice).
It carries every verb the runtime (`repro_torch.core`) and the trainer's
checkpoints call: deletes (``delete_many``, ``delete_prefix``),
``put_content_addressed``, ``publish_result`` and ``watch_tick_s``.

Semantics reproduced from the paper's use of S3:
  * whole-object atomic ``put`` / ``get`` (no partial writes ever visible);
  * ``put_if_absent`` -- the atomic-write primitive the paper relies on for
    exactly-once result visibility;
  * ``list(prefix)``; no append.

Batched verbs (``get_many``/``put_many``/``exists_many``)
charge one amortized round-trip per batch (request latency + summed
transfer).  Every successful put fires ``notify_put`` on the backend's
watch condition naming the keys that landed, so ``wait_keys`` is purely
event-driven: snapshot ``put_seq()``, check, then block in ``wait_put``.
Every operation is charged virtual wire time from a
:class:`~repro_torch.storage.perf_model.StorageProfile` and recorded in a
:class:`Ledger`.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .perf_model import S3_2017, StorageProfile

# Store handles pickle BY REFERENCE (like an S3 client: the serialized form
# is an endpoint, not the data); in-memory handles resolve only in the
# process that made them.
_HANDLE_REGISTRY: "weakref.WeakValueDictionary[str, Any]" = weakref.WeakValueDictionary()


def _resolve_handle(uid: str) -> Any:
    try:
        return _HANDLE_REGISTRY[uid]
    except KeyError:
        raise RuntimeError(
            f"storage handle {uid} not live in this process "
            "(in-memory handles cannot cross processes)"
        ) from None


class _Endpoint:
    """Mixin giving a class by-reference pickling semantics: the unpickled
    handle IS the original object."""

    def _register_endpoint(self) -> None:
        self._endpoint_uid = f"{type(self).__name__}-{uuid.uuid4().hex}"
        _HANDLE_REGISTRY[self._endpoint_uid] = self

    def __reduce__(self):
        return (_resolve_handle, (self._endpoint_uid,))


@dataclass
class OpRecord:
    worker: str
    op: str  # "get" | "put" | "list" | "delete" | "head" | batched variants
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


# Fallback re-check interval for key watchers on a cross-process backend
# without a watch thread (none in the port: its one backend is in memory).
WATCH_FALLBACK_TICK_S = 0.25


class InMemoryBackend:
    """Process-local object map with a put-event watch (condition + a ring
    of (seq, keys) so waiters retire exactly the keys that landed)."""

    _RECENT_PUTS = 512
    # the backend flags the runtime reads: an in-memory map is reached
    # only through in-process handles, stores references (so puts copy),
    # and does not echo this handle's own puts
    cross_process = False
    self_watching = False
    echoes_puts = False
    zero_copy_puts = False

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}
        self._watch_cv = threading.Condition()
        self._watch_seq = 0
        self._recent_puts: deque = deque(maxlen=self._RECENT_PUTS)

    # ---- watch -----------------------------------------------------------
    def notify_put(self, keys: Optional[List[str]] = None) -> None:
        with self._watch_cv:
            self._watch_seq += 1
            self._recent_puts.append((self._watch_seq, tuple(keys) if keys is not None else None))
            self._watch_cv.notify_all()

    def put_seq(self) -> int:
        with self._watch_cv:
            return self._watch_seq

    def puts_since(self, last_seq: int) -> Tuple[int, Optional[set]]:
        """(current seq, keys put after ``last_seq``), or (seq, None) when
        the ring cannot say (overflow or an event without keys)."""
        with self._watch_cv:
            cur = self._watch_seq
            if cur == last_seq:
                return cur, set()
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

    # ---- data ------------------------------------------------------------
    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        return self.put_many({key: blob}, if_absent=if_absent) == 1

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

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._data[k] for k in keys if k in self._data}

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


class ObjectStore(_Endpoint):
    """The remote bulk store.  All durable runtime state lives here."""

    def __init__(
        self,
        backend: Optional[InMemoryBackend] = None,
        profile: StorageProfile = S3_2017,
        ledger: Optional[Ledger] = None,
    ) -> None:
        self.backend = backend or InMemoryBackend()
        self.profile = profile
        self.ledger = ledger or Ledger()
        # tick-bounded (non-event-driven) waits on this handle; stays 0
        # unless a caller passes ``poll_s``
        self.fallback_tick_waits = 0
        self._register_endpoint()

    def _charge(self, worker: str, op: str, key: str, nbytes: int, vt: float) -> None:
        self.ledger.record(OpRecord(worker, op, key, nbytes, vt, time.monotonic()))

    # ---- key watch (delegates to the backend) ------------------------------
    def notify_put(self, key: Optional[str] = None) -> None:
        self.backend.notify_put([key] if key is not None else None)

    def put_seq(self) -> int:
        return self.backend.put_seq()

    def puts_since(self, last_seq: int):
        return self.backend.puts_since(last_seq)

    def wait_put(self, last_seq: int, timeout_s: float) -> int:
        return self.backend.wait_put(last_seq, timeout_s)

    # ---- raw byte plane --------------------------------------------------
    def put_bytes(self, key: str, blob: bytes, *, worker: str = "-", if_absent: bool = False) -> bool:
        won = self.backend.put(key, blob, if_absent=if_absent)
        self._charge(worker, "put", key, len(blob), self.profile.write_time(len(blob)))
        if won:
            self.backend.notify_put([key])
        return won

    def put_many_bytes(
        self, items: Dict[str, bytes], *, worker: str = "-", if_absent: bool = False
    ) -> int:
        """One backend call, one amortized round-trip, one ``notify_put``.
        With ``if_absent`` each key keeps first-writer-wins; returns keys won."""
        if not items:
            return 0
        won = self.backend.put_many(dict(items), if_absent=if_absent)
        total = sum(len(b) for b in items.values())
        vt = self.profile.write_latency_s + total / self.profile.write_bw_per_conn
        self._charge(worker, "mput", f"[{len(items)} keys]", total, vt)
        if won:
            self.backend.notify_put(list(items))
        return won

    def get_bytes(self, key: str, *, worker: str = "-") -> bytes:
        blob = self.backend.get(key)
        self._charge(worker, "get", key, len(blob), self.profile.read_time(len(blob)))
        return blob

    def get_many_bytes(self, keys: List[str], *, worker: str = "-") -> Dict[str, bytes]:
        blobs = self.backend.get_many(list(keys))
        total = sum(len(b) for b in blobs.values())
        vt = self.profile.read_latency_s + total / self.profile.read_bw_per_conn
        self._charge(worker, "mget", f"[{len(keys)} keys]", total, vt)
        return blobs

    def exists_many(self, keys: List[str], *, worker: str = "-") -> set:
        self._charge(worker, "mhead", f"[{len(keys)} keys]", 0, self.profile.read_latency_s)
        return self.backend.exists_many(list(keys))

    def delete(self, key: str, *, worker: str = "-") -> None:
        self.backend.delete(key)
        self._charge(worker, "delete", key, 0, self.profile.write_latency_s)

    def delete_many(self, keys: List[str], *, worker: str = "-") -> None:
        """One amortized round-trip for the whole batch."""
        for k in keys:
            self.backend.delete(k)
        self._charge(worker, "mdel", f"[{len(keys)} keys]", 0, self.profile.write_latency_s)

    def delete_prefix(self, prefix: str, *, worker: str = "-") -> int:
        """Delete every key under ``prefix`` (job GC); returns the count."""
        keys = self.list(prefix, worker=worker)
        if keys:
            self.delete_many(keys, worker=worker)
        return len(keys)

    def list(self, prefix: str, *, worker: str = "-") -> List[str]:
        self._charge(worker, "list", prefix, 0, self.profile.read_latency_s)
        return self.backend.list(prefix)

    # ---- object plane (serialized values) --------------------------------
    def put(self, key: str, value: Any, *, worker: str = "-", if_absent: bool = False) -> bool:
        return self.put_bytes(key, serialization.dumps(value), worker=worker, if_absent=if_absent)

    def get(self, key: str, *, worker: str = "-") -> Any:
        return serialization.loads(self.get_bytes(key, worker=worker))

    def get_many(self, keys: List[str], *, worker: str = "-", missing: str = "omit") -> Dict[str, Any]:
        """``missing="omit"`` drops absent keys; ``"error"`` raises KeyError."""
        blobs = self.get_many_bytes(keys, worker=worker)
        if missing == "error" and len(blobs) < len(set(keys)):
            absent = [k for k in keys if k not in blobs]
            raise KeyError(f"{len(absent)} keys absent, e.g. {absent[:3]}")
        return {k: serialization.loads(b) for k, b in blobs.items()}

    def put_many(self, items: Dict[str, Any], *, worker: str = "-", if_absent: bool = False) -> int:
        return self.put_many_bytes(
            {k: serialization.dumps(v) for k, v in items.items()},
            worker=worker, if_absent=if_absent,
        )

    def put_content_addressed(self, prefix: str, value: Any, *, worker: str = "-") -> str:
        """PyWren's 'globally unique keys': the key is the blob's content
        hash, so duplicate puts of identical content are idempotent."""
        key, blob = serialization.dumps_with_key(prefix, value)
        self.put_bytes(key, blob, worker=worker, if_absent=True)
        return key

    # ---- completion signalling -------------------------------------------
    def publish_result(self, key: str, value: Any, *, worker: str = "-") -> bool:
        """Atomic publish: first writer wins; existence of ``key`` is the
        task's completion."""
        return self.put(key, value, worker=worker, if_absent=True)

    def watch_tick_s(self, poll_s: Optional[float] = None) -> Optional[float]:
        """Fallback re-check interval for key watchers: None (purely
        event-driven) unless ``poll_s`` is given or the backend is
        cross-process without a watcher."""
        if poll_s is not None:
            return poll_s
        if self.backend.cross_process and not self.backend.self_watching:
            return WATCH_FALLBACK_TICK_S
        return None

    def wait_keys(
        self, keys: List[str], *, poll_s: Optional[float] = None, timeout_s: float = 60.0
    ) -> None:
        """Block until all keys exist; woken by each put event, which names
        the keys it landed.  ``poll_s`` forces a re-check tick (counted in
        ``fallback_tick_waits``)."""
        deadline = time.monotonic() + timeout_s
        tick = self.watch_tick_s(poll_s)
        pending = list(keys)
        seq: Optional[int] = None
        while True:
            if seq is None or tick is not None:
                seq = self.put_seq()
                present = self.backend.exists_many(pending)
            else:
                seq, landed = self.puts_since(seq)
                present = self.backend.exists_many(pending) if landed is None else landed
            pending = [k for k in pending if k not in present]
            if not pending:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{len(pending)} keys still absent, e.g. {pending[:3]}")
            if tick is None:
                self.wait_put(seq, remaining)
            else:
                self.fallback_tick_waits += 1
                self.wait_put(seq, min(tick, remaining))
