"""``repro-kvd``: the wire-protocol KV/object server (a copy of
`repro.storage.net_server`; its frames are read and written with the
port's wire pickle, so JAX and torch clients share one daemon, and its
data directory is the JAX daemon's layout).

    python -m repro_torch.storage.net_server --root DIR [--port N | --uds PATH]

prints ``LISTENING <address>`` once it accepts connections.

One process owns a data directory and serves the :mod:`.net_kv` protocol
over TCP or a Unix socket.  Persistence is the log-structured engine for BOTH
planes — a :class:`~repro_torch.storage.file_kv.FileKVStore` in *exclusive*
mode (sole owner: no cross-process flock, no per-op stat, same framed
crash-safe appends) for the KV plane, and a second one holding blobs for
the object plane (:class:`_LogBlobs`).  That is the whole performance
story: a wire round-trip to a process that answers from materialized
state and persists by appending beats a shared-disk transaction that
must flock, stat, and replay — or open, write, and rename a file per
object.

Request execution
-----------------
Each connection is served by one thread: requests pipelined on a
connection execute in arrival order; concurrency comes from concurrent
connections, serialized per shard by the engine's shard locks exactly as
concurrent in-process threads are.  Ops dispatch through explicit
allowlists (``_KV_OPS`` / ``_OB_OPS``) — an unknown op is a clean
``err`` frame, and a malformed frame closes only the offending
connection (the decoder raises before anything executes, so a torn or
corrupt pipeline can never leave a transaction half-applied).  A whole
frame that names a global the port cannot resolve (a JAX client's
cloudpickled closure, a class with no twin in the port) is answered
with an ``err`` frame, and the connection lives on.

Three ops don't pass straight through:

* ``kv.eval`` / ``kv.eval_many`` — run ``fn(old)`` inside the shard
  transaction but return the *pre-image* (snapshotted by value before
  ``fn`` can mutate it); the client replays ``fn`` on that pre-image to
  reproduce closure side effects.  See :mod:`.net_kv`.
* ``kv.lpop_n`` — destructive reads journal non-empty results under
  ``net-ack/{client}/{rid}`` *in the popped key's own shard
  transaction*, so a client retrying a pop whose response was lost gets
  the journaled items instead of popping again (ack records are only
  ever addressed through the popped key's shard, which keeps the
  journal and the pop atomic).  The client retires ack records with its
  next pop of the same key.

Watch push
----------
The server keeps per-shard KV sequences and one object sequence.  Every
mutation broadcasts a keyed wake frame — ``("kv", shard, seq, keys)`` or
``("obj", seq, keys)`` — to every subscribed connection *including the
writer's own* (clients charge locally but never self-touch; the echo is
what advances their local shard sequences).  Wakes are hints: a waiter
re-probes its predicate on wake, so cross-shard ordering races between
handler threads are benign.  The ``hello`` reply carries the server
generation (fresh UUID per boot) and current sequences, which is what
lets a reconnecting client resync after a restart.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .file_kv import FileKVStore
from .kv_store import DELETE
from .net_kv import (
    FrameDecoder,
    ProtocolError,
    UnresolvedMessage,
    _sendall_parts,
    encode_wire,
    encode_wire_parts,
    extract_buffers,
)

_ABSENT = object()

# Responses whose payloads may ride zero-copy buffer frames when the
# client advertised ``zero_copy`` at sub time.  Only the bulk read paths
# qualify — everything else stays one small pickle.
_ZC_RESPONSES = frozenset({"ob.get", "ob.get_many", "kv.get", "kv.mget", "kv.lrange"})

# Watch-event frames queued per connection before backpressure kicks in.
# On overflow the whole backlog collapses into one conservative resync
# wake — wakes are hints, so dropping them loses precision, never a wake.
MAX_PUSH_QUEUE = 256


def _eval_preimage(fn, stored, default):
    """``(pre_image, fn_argument)`` for one eval key.  An arbitrary fn may
    mutate its argument in place, so it gets a deep copy and the pristine
    copy becomes the returned pre-image.  Functions marked with
    :func:`repro_torch.storage.kv_pure` promise not to, so the stored object is
    handed over (and returned) directly — skipping a pickle round-trip per
    key that dominates eval cost when records carry whole task specs."""
    if getattr(getattr(fn, "func", fn), "__kv_pure__", False):
        return (default, default) if stored is _ABSENT else (stored, stored)
    if stored is _ABSENT:
        return default, pickle.loads(pickle.dumps(default))
    return pickle.loads(pickle.dumps(stored)), stored


class _LogBlobs:
    """The server-side object tier, persisted in the SAME log-structured
    engine as the KV plane: a second exclusive :class:`FileKVStore` whose
    values are the blobs.  A put is one framed crash-safe append plus a
    RAM index update; gets answer from materialized state with no file
    opens.  This is what makes the wire tier faster than the shared-disk
    ``FileBackend`` on the object plane — that backend pays an open +
    write + rename (and a readdir per list) per object, where a log
    append is a single buffered write.  ``ckpt/`` keys keep FileBackend's
    machine-crash durability via the engine's ``durable_prefixes``."""

    def __init__(self, root: str, *, num_shards: int, fsync: str) -> None:
        self.kv = FileKVStore(
            root,
            num_shards=num_shards,
            fsync=fsync,
            durable_prefixes=("ckpt/",),
            exclusive=True,
            charged=False,
        )

    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        if if_absent:
            return self.kv.setnx(key, blob)
        self.kv.set(key, blob)
        return True

    def put_many(self, items: Dict[str, bytes], *, if_absent: bool) -> int:
        if if_absent:
            return sum(1 for k, b in items.items() if self.kv.setnx(k, b))
        self.kv.mset(dict(items))
        return len(items)

    def get(self, key: str) -> bytes:
        blob = self.kv.get(key, _ABSENT)
        if blob is _ABSENT:
            raise KeyError(key)
        return blob

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        out = self.kv.mget(list(keys), default=_ABSENT)
        return {k: v for k, v in zip(keys, out) if v is not _ABSENT}

    def exists(self, key: str) -> bool:
        return self.kv.exists(key)

    def exists_many(self, keys: List[str]) -> set:
        out = self.kv.mget(list(keys), default=_ABSENT)
        return {k for k, v in zip(keys, out) if v is not _ABSENT}

    def delete(self, key: str) -> None:
        self.kv.delete(key)

    def list(self, prefix: str) -> List[str]:
        return sorted(self.kv.scan(prefix))

    def close(self) -> None:
        self.kv.close()

# Straight pass-through ops (server-side method name == wire op name).
_KV_OPS = frozenset(
    {
        "set", "get", "mget", "mset", "setnx", "incr", "cas", "delete",
        "mdel", "exists", "scan", "rpush", "rpush_many", "lrange", "llen",
    }
)
_OB_OPS = frozenset(
    {"get", "get_many", "exists", "exists_many", "delete", "list"}
)

# Which KV pass-through ops mutate, and what they touch (conditional
# writers touch only when they won — the returned value says).
_KV_WRITES = {
    "set": lambda args, value: [args[0]],
    "incr": lambda args, value: [args[0]],
    "delete": lambda args, value: [args[0]],
    "rpush": lambda args, value: [args[0]],
    "setnx": lambda args, value: [args[0]] if value else [],
    "cas": lambda args, value: [args[0]] if value else [],
    "mset": lambda args, value: list(args[0]),
    "rpush_many": lambda args, value: list(args[0]),
    "mdel": lambda args, value: list(args[0]),
}


class _ServerConn:
    """One accepted connection: socket, its subscription, and a send lock
    (responses from the conn's own thread interleave with pushes from the
    conn's own pusher thread).

    Watch events never block a writer: they enqueue on a BOUNDED per-
    connection queue drained by a dedicated pusher thread (started only
    for subscribed connections).  A slow watcher fills its queue; on
    overflow the backlog is dropped and replaced by one conservative
    resync wake (unknown keys, current sequences) — every waiter
    re-probes, so backpressure costs precision, never a lost wake, and a
    stalled consumer can no longer grow server memory without bound or
    stall op threads in ``sendall``."""

    def __init__(self, sock: socket.socket, peer: str) -> None:
        self.sock = sock
        self.peer = peer
        self.send_lock = threading.Lock()
        self.client_id: Optional[str] = None
        self.topics: Tuple[str, ...] = ()
        self.zero_copy = False
        self.alive = True
        self._push_q: deque = deque()
        self._push_cond = threading.Condition()
        self._push_overflow = False
        self._push_thread: Optional[threading.Thread] = None
        self._push_closed = False

    def send(self, msg: Any) -> None:
        self.send_bytes(encode_wire(msg))

    def send_bytes(self, frame: bytes) -> None:
        with self.send_lock:
            self.sock.sendall(frame)

    def send_parts(self, parts: List[Any]) -> None:
        with self.send_lock:
            _sendall_parts(self.sock, parts)

    # ---- backpressured event push ---------------------------------------
    def start_pusher(self, resync_frames) -> None:
        """Start the pusher thread (idempotent).  ``resync_frames(conn)``
        supplies the conservative wake frames sent after an overflow."""
        with self._push_cond:
            if self._push_thread is not None or self._push_closed:
                return
            self._push_thread = threading.Thread(
                target=self._push_loop,
                args=(resync_frames,),
                daemon=True,
                name=f"kvd-push-{self.peer}",
            )
            self._push_thread.start()

    def push(self, frame: bytes) -> None:
        """Enqueue one event frame; never blocks the calling op thread."""
        with self._push_cond:
            if self._push_closed:
                return
            if len(self._push_q) >= MAX_PUSH_QUEUE:
                self._push_q.clear()
                self._push_overflow = True
            else:
                self._push_q.append(frame)
            self._push_cond.notify()

    def _push_loop(self, resync_frames) -> None:
        while True:
            with self._push_cond:
                while not (self._push_q or self._push_overflow or self._push_closed):
                    self._push_cond.wait()
                if self._push_closed:
                    return
                overflow, self._push_overflow = self._push_overflow, False
                batch = list(self._push_q)
                self._push_q.clear()
            try:
                if overflow:
                    # The dropped backlog becomes one unknown-keys wake per
                    # subscribed stream, carrying the CURRENT sequences
                    # (computed now, so nothing that happened during the
                    # stall is missed).  Frames enqueued after the overflow
                    # follow behind; their older sequences are harmless
                    # (clients take the max and touches are additive).
                    for frame in resync_frames(self):
                        self.send_bytes(frame)
                for frame in batch:
                    self.send_bytes(frame)
            except OSError:
                self.alive = False
                return

    def close_push(self) -> None:
        with self._push_cond:
            self._push_closed = True
            self._push_q.clear()
            self._push_cond.notify_all()


class KVDServer:
    """The ``repro-kvd`` server.  ``start()`` begins accepting; ``port`` is
    the bound port (pass ``port=0`` to let the OS pick).  ``num_shards``
    must match across restarts over the same root (it is the layout of the
    persisted shard logs)."""

    def __init__(
        self,
        root: str,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        num_shards: int = 8,
        fsync: str = "auto",
    ) -> None:
        self.root = os.path.abspath(root)
        self.kv = FileKVStore(
            os.path.join(self.root, "kv"),
            num_shards=num_shards,
            fsync=fsync,
            exclusive=True,
            charged=False,
        )
        self.ob = _LogBlobs(
            os.path.join(self.root, "obj"), num_shards=num_shards, fsync=fsync
        )
        self.generation = uuid.uuid4().hex
        self.num_shards = num_shards
        self._kv_seqs = [0] * num_shards
        self._obj_seq = 0
        self._seq_lock = threading.Lock()
        self._conns: Dict[int, _ServerConn] = {}
        self._watches: Dict[str, set] = {}  # client_id -> watched kv keys
        # Lock-free push prefilters, rebuilt under _conn_lock on the rare
        # mutations (watch registration, subscription, connection close) and
        # read WITHOUT the lock on every write op.  Safe against the
        # register race: a watch registration updates the union BEFORE it
        # reads the shard seq for its reply, so a write that misses the
        # fresh union necessarily bumped the seq first — the client sees
        # the mismatch in the registration reply and self-wakes.
        self._watch_union: frozenset = frozenset()
        self._obj_subs = False
        self._conn_lock = threading.Lock()
        self._conn_ids = iter(range(1, 1 << 62))
        self._stop = threading.Event()
        if host.startswith("unix:"):
            # Same-host transport: a Unix socket halves the per-round-trip
            # syscall cost vs loopback TCP (no TCP stack traversal).
            path = host[len("unix:"):]
            try:
                os.unlink(path)  # stale socket from a SIGKILLed predecessor
            except FileNotFoundError:
                pass
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
            self.host, self.port = host, 0
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self.host, self.port = self._listener.getsockname()[:2]
        self._listener.listen(128)
        self._accepter = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"kvd-accept-{self.port}"
        )

    @property
    def address(self) -> str:
        if self.host.startswith("unix:"):
            return self.host
        return f"{self.host}:{self.port}"

    def start(self) -> "KVDServer":
        self._accepter.start()
        return self

    def serve_forever(self) -> None:
        self.start()
        self._stop.wait()

    def close(self) -> None:
        self._stop.set()
        try:
            # wakes the accept loop's blocked accept(), which a close alone
            # does not on Linux (the join below would wait out its timeout)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close_push()
            try:
                conn.sock.close()
            except OSError:
                pass
        if self._accepter.is_alive():
            self._accepter.join(timeout=2.0)
        self.kv.close()
        self.ob.close()

    # ---- accept / connection plane --------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            if sock.family != socket.AF_UNIX:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = f"{addr[0]}:{addr[1]}" if isinstance(addr, tuple) else str(addr)
            conn = _ServerConn(sock, peer)
            cid = next(self._conn_ids)
            with self._conn_lock:
                self._conns[cid] = conn
            threading.Thread(
                target=self._conn_loop,
                args=(cid, conn),
                daemon=True,
                name=f"kvd-conn-{cid}",
            ).start()

    def _conn_loop(self, cid: int, conn: _ServerConn) -> None:
        decoder = FrameDecoder()
        try:
            while not self._stop.is_set():
                if decoder.wanted():
                    # Mid-buffer-frame: recv straight into the payload's
                    # final bytearray (a large zero-copy put lands without
                    # intermediate copies).
                    got = conn.sock.recv_into(decoder.fill_view())
                    if not got:
                        return
                    decoder.filled(got)
                    continue
                data = conn.sock.recv(1 << 16)
                if not data:
                    return
                for msg in decoder.feed(data):
                    self._on_msg(conn, msg)
        except ProtocolError:
            # Malformed input: this connection is garbage — drop it, serve
            # everyone else.  Nothing was applied for the corrupt frame
            # (ops only run on whole, CRC-valid frames).
            return
        except OSError:
            return
        finally:
            conn.alive = False
            with self._conn_lock:
                self._conns.pop(cid, None)
                # Reap the client's watch set once its LAST connection is
                # gone (request and event channels share a client_id).
                if conn.client_id is not None and not any(
                    c.client_id == conn.client_id for c in self._conns.values()
                ):
                    self._watches.pop(conn.client_id, None)
                self._rebuild_push_filters()
            conn.close_push()
            try:
                conn.sock.close()
            except OSError:
                pass

    def _on_msg(self, conn: _ServerConn, msg: Any) -> None:
        if isinstance(msg, UnresolvedMessage):
            inner = msg.msg
            kind = inner[0] if isinstance(inner, tuple) and inner else None
            if kind == "req" and len(inner) == 5 and conn.client_id is not None:
                conn.send(("err", inner[1], "ModuleNotFoundError",
                           f"{inner[2]}: {msg.describe()}"))
                return
            if kind == "cast" and conn.client_id is not None:
                return  # a cast has no handle to fail: dropped, as a failing cast is
            raise ProtocolError(f"malformed message: {msg.describe()}")
        if not (isinstance(msg, tuple) and msg and isinstance(msg[0], str)):
            raise ProtocolError(f"malformed message: {msg!r}")
        kind = msg[0]
        if kind == "sub":
            conn.client_id = str(msg[1])
            conn.topics = tuple(msg[2])
            if len(msg) > 3 and isinstance(msg[3], dict):
                conn.zero_copy = bool(msg[3].get("zero_copy", False))
            if conn.topics:
                conn.start_pusher(self._resync_frames)
            with self._conn_lock:
                self._rebuild_push_filters()
            with self._seq_lock:
                hello = {
                    "gen": self.generation,
                    "num_shards": self.num_shards,
                    "kv_seqs": list(self._kv_seqs),
                    "obj_seq": self._obj_seq,
                }
            conn.send(("hello", hello))
            return
        if kind == "cast":
            # Fire-and-forget op: execute, push wakes, send nothing back.
            # A failing cast is dropped (the client holds no handle to fail)
            # — malformed *framing* still kills the connection above.
            if conn.client_id is None:
                raise ProtocolError("cast before sub handshake")
            _kind, op, args, kwargs = msg
            try:
                _value, frames = self._execute(conn, 0, op, args, kwargs)
            except ProtocolError:
                raise
            except Exception:
                return
            self._push_events(frames)
            return
        if kind != "req":
            raise ProtocolError(f"unknown message kind {kind!r}")
        if conn.client_id is None:
            raise ProtocolError("req before sub handshake")
        _kind, rid, op, args, kwargs = msg
        try:
            value, frames = self._execute(conn, rid, op, args, kwargs)
        except ProtocolError:
            raise
        except Exception as exc:  # clean per-op failure, never a crash
            conn.send(("err", rid, type(exc).__name__, str(exc)))
            return
        buffers: List[Any] = []
        if conn.zero_copy and op in _ZC_RESPONSES:
            value = extract_buffers(value, buffers)
        try:
            parts = encode_wire_parts(("res", rid, value), buffers)
        except (pickle.PicklingError, TypeError, AttributeError) as exc:
            # a stored value that does not pickle by reference (a client
            # cannot send one; a data root can hold one)
            conn.send(("err", rid, type(exc).__name__, f"{op}: cannot send the result: {exc}"))
        else:
            conn.send_parts(parts)
        self._push_events(frames)

    # ---- op execution ----------------------------------------------------
    def _execute(
        self, conn: _ServerConn, rid: int, op: str, args: tuple, kwargs: dict
    ) -> Tuple[Any, List[Tuple[str, tuple]]]:
        plane, _, name = op.partition(".")
        if plane == "watch":
            # Watch registration: this client wants pushed wakes for ``key``
            # (on=True) or no longer does.  Replies with the key's current
            # server-side shard sequence so the client can detect writes
            # that landed while it was not watching (resync — no wake is
            # ever lost to the register window).
            key, on = args
            with self._conn_lock:
                watched = self._watches.setdefault(conn.client_id, set())
                if on:
                    watched.add(key)
                else:
                    watched.discard(key)
                self._rebuild_push_filters()
            sidx = self.kv.shard_of(key)
            with self._seq_lock:
                return self._kv_seqs[sidx], []
        if plane == "kv":
            if name == "eval":
                return self._kv_eval(*args)
            if name == "eval_many":
                return self._kv_eval_many(*args)
            if name == "lpop_n":
                return self._kv_lpop_n(conn.client_id, rid, *args)
            if name not in _KV_OPS:
                raise ValueError(f"unknown kv op {name!r}")
            value = getattr(self.kv, name)(*args, **kwargs)
            touched = _KV_WRITES.get(name)
            if touched is None:
                return value, []
            return value, self._kv_frames(touched(args, value))
        if plane == "ob":
            if name == "put":
                won = self.ob.put(args[0], args[1], if_absent=args[2])
                return won, (self._ob_frames([args[0]]) if won else [])
            if name == "put_many":
                n_won = self.ob.put_many(args[0], if_absent=args[1])
                # Superset hint on partial if_absent wins: waiters re-probe.
                return n_won, (self._ob_frames(list(args[0])) if n_won else [])
            if name not in _OB_OPS:
                raise ValueError(f"unknown ob op {name!r}")
            value = getattr(self.ob, name)(*args)
            if name == "delete":
                return value, self._ob_frames([args[0]])
            return value, []
        raise ValueError(f"unknown op plane {plane!r}")

    def _kv_eval(self, key: str, fn, default: Any) -> Tuple[Any, list]:
        sidx = self.kv.shard_of(key)
        with self.kv._txn(sidx) as txn:
            stored = txn.state.get(key, _ABSENT)
            pre, arg = _eval_preimage(fn, stored, default)
            new = fn(arg)
            if new is DELETE:
                txn.drop(key)
            else:
                txn.put(key, new)
        return pre, self._kv_frames([key])

    def _kv_eval_many(self, updates: Dict[str, Any], default: Any) -> Tuple[Any, list]:
        by_shard: Dict[int, List[str]] = {}
        for key in updates:
            by_shard.setdefault(self.kv.shard_of(key), []).append(key)
        pres: Dict[str, Any] = {}
        for sidx, group in sorted(by_shard.items()):
            with self.kv._txn(sidx) as txn:
                for key in group:
                    stored = txn.state.get(key, _ABSENT)
                    fn = updates[key]
                    pres[key], arg = _eval_preimage(fn, stored, default)
                    new = fn(arg)
                    if new is DELETE:
                        txn.drop(key)
                    else:
                        txn.put(key, new)
        return pres, self._kv_frames(list(updates))

    def _kv_lpop_n(
        self, client_id: str, rid: int, key: str, max_n: int, acked: List[int]
    ) -> Tuple[List[Any], list]:
        sidx = self.kv.shard_of(key)
        ack_key = f"net-ack/{client_id}/{rid}"
        with self.kv._txn(sidx) as txn:
            for old_rid in acked:
                txn.drop(f"net-ack/{client_id}/{old_rid}")
            cached = txn.state.get(ack_key, _ABSENT)
            if cached is not _ABSENT:
                # Retry of a pop whose response was lost: hand back the
                # journaled items — popping again would LOSE the originals.
                return list(cached), []
            out = txn.popleft_n(key, max_n)
            if out:
                txn.put(ack_key, list(out))
        return out, (self._kv_frames([key]) if out else [])

    # ---- watch push ------------------------------------------------------
    def _rebuild_push_filters(self) -> None:
        """Recompute the lock-free push prefilters.  Caller holds
        ``_conn_lock``; plain attribute assignment publishes the snapshot."""
        self._watch_union = frozenset().union(*self._watches.values()) \
            if self._watches else frozenset()
        self._obj_subs = any("obj" in c.topics for c in self._conns.values())

    def _kv_frames(self, keys: List[str]) -> List[Tuple[str, set, tuple]]:
        by_shard: Dict[int, List[str]] = {}
        for key in keys:
            by_shard.setdefault(self.kv.shard_of(key), []).append(key)
        frames: List[Tuple[str, set, tuple]] = []
        with self._seq_lock:
            for sidx, group in sorted(by_shard.items()):
                self._kv_seqs[sidx] += 1
                frames.append(
                    ("kv", set(group), ("kv", sidx, self._kv_seqs[sidx], group))
                )
        return frames

    def _ob_frames(self, keys: List[str]) -> List[Tuple[str, set, tuple]]:
        with self._seq_lock:
            self._obj_seq += 1
            return [("obj", set(keys), ("obj", self._obj_seq, list(keys)))]

    def _push_events(self, frames: List[Tuple[str, set, tuple]]) -> None:
        """Deliver wake frames to the connections that care.  KV events go
        only to clients whose registered watch set intersects the touched
        keys — in a running cluster the overwhelming share of writes
        (status evals, heartbeats, result records) has no watcher at all,
        and skipping those sends is a large constant-factor win on both
        sides of the wire.  Object events are topic-scoped (a client with
        an object event channel is waiting on result keys)."""
        if not frames:
            return
        # Lock-free prefilter (see __init__): in a running cluster the
        # overwhelming share of writes has no watcher and no object
        # subscriber, and a per-write _conn_lock acquisition plus conn scan
        # is measurable on the map hot path.
        union, obj_subs = self._watch_union, self._obj_subs
        frames = [
            f
            for f in frames
            if (not union.isdisjoint(f[1]) if f[0] == "kv" else obj_subs)
        ]
        if not frames:
            return
        plan: List[Tuple[tuple, List[_ServerConn]]] = []
        with self._conn_lock:
            conns = list(self._conns.values())
            for topic, keys, event in frames:
                if topic == "kv":
                    targets = [
                        c
                        for c in conns
                        if topic in c.topics
                        and c.client_id in self._watches
                        and not self._watches[c.client_id].isdisjoint(keys)
                    ]
                else:
                    targets = [c for c in conns if topic in c.topics]
                if targets:
                    plan.append((event, targets))
        for event, targets in plan:
            frame = encode_wire(event)
            for conn in targets:
                # Enqueue, never send: a slow watcher's socket can't stall
                # this (writer) thread — its pusher thread owns the send.
                conn.push(frame)

    def _resync_frames(self, conn: _ServerConn) -> List[bytes]:
        """Conservative wakes sent after a connection's push queue
        overflowed: one unknown-keys event per subscribed stream carrying
        the current sequences.  Every waiter behind the connection
        re-probes its predicate once — the dropped backlog loses no
        wake."""
        frames: List[bytes] = []
        with self._seq_lock:
            kv_seqs = list(self._kv_seqs)
            obj_seq = self._obj_seq
        if "kv" in conn.topics:
            for sidx, seq in enumerate(kv_seqs):
                frames.append(encode_wire(("kv", sidx, seq, None)))
        if "obj" in conn.topics:
            frames.append(encode_wire(("obj", obj_seq, None)))
        return frames


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="repro-kvd",
        description="Wire-protocol KV/object server over a log-structured "
        "data directory (see repro_torch.storage.net_kv).",
    )
    parser.add_argument("--root", required=True, help="data directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0, help="0 = OS-assigned")
    parser.add_argument(
        "--uds", default=None, help="Unix socket path (overrides --host/--port)"
    )
    parser.add_argument("--num-shards", type=int, default=8)
    parser.add_argument(
        "--fsync", default="auto", choices=("auto", "commit", "batch", "never")
    )
    args = parser.parse_args(argv)
    if os.environ.get("REPRO_SANITIZE") == "1":
        from repro_torch.analysis.sanitizer import install

        install()
    server = KVDServer(
        args.root,
        f"unix:{args.uds}" if args.uds else args.host,
        args.port,
        num_shards=args.num_shards,
        fsync=args.fsync,
    ).start()
    print(f"LISTENING {server.address}", flush=True)
    try:
        server._stop.wait()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
