'''Wire-protocol KV/object tier: the ``repro-kvd`` client side (a copy of
`repro.storage.net_kv` that speaks the same wire; see "One wire, two
packages" below).

:class:`NetKVStore` / :class:`NetBackend` are clients of a ``repro-kvd``
server (:mod:`.net_server`) whose persistence is the log-structured engine
of :class:`~repro_torch.storage.file_kv.FileKVStore`.  They keep the
batched contract — one frame per ``mset`` / ``mget`` / ``eval_many`` /
``rpush_many`` / ``get_many`` / ``put_many``, the in-memory store's
request-charging model — so ledgers compare across substrates.

Framing
-------
Every message is one frame: ``[u32 payload length][u32 crc32]`` followed
by a pickled payload (``_FRAME_HDR`` from :mod:`.kv_store` — the exact
bytes the shard logs use).  Messages:

==================================================  =======================================
``("req",  rid, op, args, kwargs)``                  client → server request
``("res",  rid, value)``                             server → client response
``("err",  rid, etype, msg)``                        server → client op failure
``("cast", op, args, kwargs)``                       client → server, no response
``("sub",  client_id, topics[, opts])``              client → server handshake/subscribe
``("hello", info)``                                  server → client handshake reply
``("kv",   shard, srv_seq, keys|None)``              pushed KV watch event (keyed wake)
``("obj",  srv_seq, keys|None)``                     pushed object-store watch event
==================================================  =======================================

Requests are pipelined: any number may be in flight on one socket, each
carrying a client-unique ``rid``; worker threads share one connection
and block only on their own response.  Every message is a standard
pickle: an ``eval`` function must pickle by reference (a module-level
function or a ``functools.partial`` of one — every eval the runtime
sends is one).  A request that does not pickle raises ``TypeError`` at
the caller, naming the op and the value, before anything is sent.

Zero-copy buffer frames
-----------------------
A bytes-like payload of at least :data:`ZERO_COPY_MIN` in a message's
args or result never travels through the pickle codec: it becomes a
**buffer frame** — the same header with :data:`~.kv_store.BUF_FLAG` (bit
31) set on the length, followed by the raw bytes — sent *before* its
control frame, whose pickle holds a tiny :class:`_WireBuf` index in the
payload's place.  The sender gathers headers and raw ``memoryview``
segments with ``socket.sendmsg``; the receiver's decoder allocates a torn
buffer frame's final bytearray once and the pump ``recv_into``\\ s the
socket straight into it.  Bit 31 is unambiguous: real lengths are capped
at ``MAX_FRAME_LEN`` (1 << 30).

Shard maps
----------
Both clients accept a comma-joined address string or a list of addresses
naming N daemons.  Keys route to a daemon by a hash salted apart from the
server-side shard hash (:func:`_daemon_of`, the JAX package's), and the
client's global shard space concatenates every daemon's shards.  Each
daemon has its own connection pair with its own reconnect: one daemon's
crash degrades only its shards.  Pushed watch events replace polling:
the server streams *keyed* wake frames for the keys a client watches, so
``wait_key`` / ``blpop`` / ``wait_keys`` / futures stay event-driven with
no fallback ticks.

``eval`` over the wire: deterministic replay
--------------------------------------------
Update functions may mutate captured state (``out["rec"] = cur`` riding
a partial's argument), which one-way shipping would lose.  So the server
applies ``fn(old)`` inside the shard transaction and returns ``old``; the
client replays ``fn(old)`` locally, reproducing side effects and the
return value.  Update functions must be deterministic in their argument.

Failure model
-------------
Ops are at-least-once: a connection that dies with requests in flight is
redialed (bounded backoff) and the unacknowledged requests are resent in
order.  A replayed ``lpop_n`` would lose the first pop's items, so the
server journals non-empty pop results under ``net-ack/{client}/{rid}`` in
the popped key's own shard transaction and a replay returns them; the
client retires ack records with its next pop of the same key.  On
reconnect the client wakes every local waiter with *unknown* keys, so a
wake is never lost across a server restart.  Every server generation a
client is handed (the ``hello``'s ``gen``) is kept in
:attr:`NetClient.generations`.

One wire, two packages
----------------------
Three things in a frame are pickled by reference to a module: the
:class:`_WireBuf` placeholder, the ``DELETE`` sentinel, and every eval
function and class a value carries (``TaskSpec``, the request plane's
lease functions).  The JAX package names them ``repro.*``; a plain copy
would name them ``repro_torch.*``, which a JAX daemon resolves to the
port's objects (its ``is DELETE`` would then store the sentinel) and
which the port could only read by importing ``repro``.  So:

* the port's :class:`_WirePickler` writes every function and class of a
  ``repro_torch`` module as ``getattr(importlib.import_module("repro.<m>"),
  name)``: a JAX process resolves the JAX twin (and runs JAX's copy of an
  eval function — the two packages' copies are the same code), with no
  import of ``repro_torch``;
* the port's :class:`_WireUnpickler` maps every ``repro.<m>`` it reads,
  from JAX's plain globals or from the port's own ``import_module``
  calls, onto ``repro_torch.<m>``, never importing ``repro``;
* a global this process cannot import (a ``repro`` module the port has
  no twin of, a module not installed here) and any ``jax``, ``jaxlib`` or
  ``cloudpickle`` global (a JAX client's closure arrives cloudpickled by
  value) decodes to an :class:`_Unresolved` stand-in, and the message is
  refused with a clean error (:class:`UnresolvedMessage`): the daemon
  answers ``err`` and the connection lives on.

A message with no such reference is byte-for-byte ``pickle.dumps``'s, as
the JAX package writes it.

Like Redis without AUTH, the protocol is for trusted networks only: it
is pickle over a socket, so bind the server to localhost or a private
network.
'''

from __future__ import annotations

import functools
import importlib
import io
import itertools
import pickle
import socket
import threading
import time
import types
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from .kv_store import BUF_FLAG, DELETE, MAX_FRAME_LEN, KVStore, _FRAME_HDR, _sizeof
from .object_store import Ledger, _Backend
from .perf_model import REDIS_2017, StorageProfile

# Bytes-like payloads at least this large ride out-of-band buffer frames
# instead of the pickle codec.  Below it, one small pickle is cheaper than
# an extra frame header + scatter-gather bookkeeping.
ZERO_COPY_MIN = 64 * 1024


class _WireBuf:
    """Placeholder left in a pickled message where a large bytes-like
    payload was extracted into an out-of-band buffer frame; carries only
    the payload's index in the frame's buffer list."""

    __slots__ = ("idx",)

    def __init__(self, idx: int) -> None:
        self.idx = idx

    def __reduce__(self):
        return (_WireBuf, (self.idx,))


# ---------------------------------------------------------------------------
# the wire's pickle: the port's globals under the JAX package's names
# ---------------------------------------------------------------------------

_PORT, _JAX = "repro_torch", "repro"
# Top-level packages whose globals the port never imports from a frame.
_NEVER_IMPORTED = frozenset({"jax", "jaxlib", "cloudpickle", _JAX})


def _renamed(module: str, old: str, new: str) -> Optional[str]:
    """``old.<m>`` -> ``new.<m>``; None for a module outside ``old``."""
    if module == old or module.startswith(old + "."):
        return new + module[len(old):]
    return None


class _ModuleRef:
    """Pickles as ``importlib.import_module(name)``."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __reduce__(self):
        return (importlib.import_module, (self.name,))


class _WirePickler(pickle.Pickler):
    """The C pickler, writing each module-level function and class of a
    ``repro_torch`` module as its JAX twin's name (module docstring).
    Containers, strings, bytes and numbers never reach
    ``reducer_override``, so a message holding nothing else is
    ``pickle.dumps``'s bytes."""

    def __init__(self, file) -> None:
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._modules: Dict[str, _ModuleRef] = {}  # one ref per module: memoized

    def reducer_override(self, obj):
        if not isinstance(obj, (type, types.FunctionType)) or "." in obj.__qualname__:
            return NotImplemented
        module = _renamed(getattr(obj, "__module__", None) or "", _PORT, _JAX)
        if module is None:
            return NotImplemented
        ref = self._modules.setdefault(module, _ModuleRef(module))
        return (getattr, (ref, obj.__qualname__))


def _wire_dumps(obj: Any) -> bytes:
    """``pickle.dumps(obj)`` when that names no ``repro_torch`` global
    (every global's module is spelled out in a pickle, so the substring
    test is exact for those and at worst sends a message with the name in
    its data through :class:`_WirePickler`, which writes it the same way);
    else the wire pickler's bytes.  The fast path keeps large data-plane
    messages in C, without a Python call per object."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if _PORT.encode() not in payload:
        return payload
    buf = io.BytesIO()
    _WirePickler(buf).dump(obj)
    return buf.getvalue()


class _Unresolved:
    """Stands in, while a frame decodes, for a global this package cannot
    resolve; it takes any construction, state and items, so the frame
    decodes whole and the message holding it is refused by name
    (:class:`UnresolvedMessage`) instead of killing the connection."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    def __call__(self, *args: Any, **kwargs: Any) -> "_Unresolved":
        return _Unresolved()

    def __getattr__(self, name: str) -> "_Unresolved":
        if name.startswith("__"):
            raise AttributeError(name)
        return _Unresolved()

    def __setstate__(self, state: Any) -> None:
        pass

    def __setitem__(self, key: Any, value: Any) -> None:
        pass

    def append(self, item: Any) -> None:
        pass

    def extend(self, items: Any) -> None:
        pass


class UnresolvedMessage:
    """A whole, CRC-valid message that names globals this package cannot
    resolve (``names``); ``msg`` holds :class:`_Unresolved` in their
    place.  The server answers such a request with an ``err`` frame; the
    client fails the call it answers."""

    __slots__ = ("msg", "names")

    def __init__(self, msg: Any, names: List[str]) -> None:
        self.msg = msg
        self.names = names

    def describe(self) -> str:
        return (f"the frame names {sorted(set(self.names))}, which this process cannot "
                "resolve (not importable here, no twin in the port, or a package the "
                "port never imports)")


class _WireUnpickler(pickle.Unpickler):
    """The C unpickler, resolving ``repro.<m>`` to ``repro_torch.<m>``; a
    global it cannot resolve is recorded in ``unresolved`` and stood in for
    by :class:`_Unresolved`."""

    def __init__(self, data: bytes) -> None:
        super().__init__(io.BytesIO(data))
        self.unresolved: List[str] = []

    @staticmethod
    def _local(module: str) -> Optional[str]:
        """The module this process reads ``module`` as; None: never imported."""
        twin = _renamed(module, _JAX, _PORT)
        if twin is None and module.partition(".")[0] in _NEVER_IMPORTED:
            return None
        return twin or module

    def _import_module(self, name: str):
        local = self._local(name)
        if local is not None:
            try:
                return importlib.import_module(local)
            except ImportError:
                pass
        self.unresolved.append(name)
        return _Unresolved()

    def find_class(self, module: str, name: str):
        if (module, name) == ("importlib", "import_module"):
            return self._import_module
        local = self._local(module)
        if local is not None:
            try:
                return super().find_class(local, name)
            except (ImportError, AttributeError):
                pass
        self.unresolved.append(f"{module}.{name}")
        return _Unresolved


def _wire_loads(payload: bytes) -> Any:
    unpickler = _WireUnpickler(payload)
    msg = unpickler.load()
    return UnresolvedMessage(msg, unpickler.unresolved) if unpickler.unresolved else msg


def _unpicklable(obj: Any) -> Any:
    """The innermost value of ``obj`` (through tuples, lists, dict values
    and partials) that does not pickle."""
    if isinstance(obj, (tuple, list)):
        kids = list(obj)
    elif isinstance(obj, dict):
        kids = list(obj.values())
    elif isinstance(obj, functools.partial):
        kids = [obj.func, *obj.args, *obj.keywords.values()]
    else:
        return obj
    for kid in kids:
        try:
            _wire_dumps(kid)
        except (pickle.PicklingError, TypeError, AttributeError):
            return _unpicklable(kid)
    return obj


def _as_byte_view(obj) -> memoryview:
    view = obj if isinstance(obj, memoryview) else memoryview(obj)
    if view.ndim != 1 or view.format != "B":
        view = view.cast("B")
    return view


def extract_buffers(obj: Any, buffers: List[memoryview], min_bytes: int = ZERO_COPY_MIN) -> Any:
    """Walk ``obj`` (tuples/lists/dicts of anything), pulling every
    bytes-like leaf of at least ``min_bytes`` out into ``buffers`` and
    leaving a :class:`_WireBuf` index in its place.  Small ``memoryview``
    leaves are normalized to ``bytes`` (memoryviews don't pickle).  The
    input structure is never mutated — new containers are built on the
    extraction path."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        view = _as_byte_view(obj)
        if view.nbytes >= min_bytes:
            buffers.append(view)
            return _WireBuf(len(buffers) - 1)
        return bytes(obj) if isinstance(obj, memoryview) else obj
    if isinstance(obj, tuple):
        return tuple(extract_buffers(v, buffers, min_bytes) for v in obj)
    if isinstance(obj, list):
        return [extract_buffers(v, buffers, min_bytes) for v in obj]
    if isinstance(obj, dict):
        return {k: extract_buffers(v, buffers, min_bytes) for k, v in obj.items()}
    return obj


def bind_buffers(obj: Any, buffers: List[Any]) -> Any:
    """Inverse of :func:`extract_buffers`: splice received raw buffer
    payloads back over their :class:`_WireBuf` placeholders."""
    if isinstance(obj, _WireBuf):
        try:
            return buffers[obj.idx]
        except IndexError:
            raise ProtocolError(
                f"buffer placeholder #{obj.idx} without a matching buffer frame"
            )
    if isinstance(obj, tuple):
        return tuple(bind_buffers(v, buffers) for v in obj)
    if isinstance(obj, list):
        return [bind_buffers(v, buffers) for v in obj]
    if isinstance(obj, dict):
        return {k: bind_buffers(v, buffers) for k, v in obj.items()}
    return obj


def _daemon_of(key: str, n: int) -> int:
    """Which daemon of an N-entry shard map owns ``key``.  The hash is
    salted to decorrelate it from the server-side ``crc32(key) % shards``
    routing — the unsalted hash would alias with it and leave some server
    shards permanently cold."""
    if n == 1:
        return 0
    return zlib.crc32(b"d~" + key.encode()) % n


def _addr_str(addr: Tuple[str, int]) -> str:
    host, port = addr
    return host if host.startswith("unix:") else f"{host}:{port}"


class ProtocolError(Exception):
    """Malformed wire data (bad CRC, oversized length, undecodable
    payload).  The peer that sent it gets its connection closed — never a
    crash, never a partially applied transaction (ops only execute on
    whole, valid frames)."""


class RemoteError(RuntimeError):
    """A server-side op raised; carries ``etype`` (the remote exception
    class name) and the stringified message."""

    def __init__(self, etype: str, msg: str) -> None:
        super().__init__(f"{etype}: {msg}")
        self.etype = etype


def encode_wire(obj: Any) -> bytes:
    """One message → one frame (same header as the shard logs)."""
    payload = _wire_dumps(obj)
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def encode_wire_parts(obj: Any, buffers: List[memoryview]) -> List[Any]:
    """One message + its extracted buffers → a list of byte segments for a
    gathered send.  Buffer frames travel *before* the control frame, so the
    receiver has every raw payload in hand when the pickled message that
    references them decodes.  The segments are headers (bytes) interleaved
    with the raw payload ``memoryview``\\ s — nothing large is joined or
    copied here."""
    parts: List[Any] = []
    for view in buffers:
        parts.append(_FRAME_HDR.pack(BUF_FLAG | view.nbytes, zlib.crc32(view)))
        parts.append(view)
    payload = _wire_dumps(obj)
    parts.append(_FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
    return parts


# sendmsg gathers at most IOV_MAX segments per call (1024 on Linux); stay
# far under it so one oversized batch can never fail outright.
_SENDMSG_SEGS = 64


def _sendall_parts(sock: socket.socket, parts: List[Any]) -> None:
    """Gathered ``sendall``: pushes every segment with ``socket.sendmsg``,
    advancing through partial sends, so large payload views go to the
    kernel without ever being joined into one contiguous frame."""
    segs = [_as_byte_view(p) for p in parts]
    i = 0
    while i < len(segs):
        batch = segs[i : i + _SENDMSG_SEGS]
        sent = sock.sendmsg(batch)
        for s in batch:
            if sent >= s.nbytes:
                sent -= s.nbytes
                i += 1
            else:
                segs[i] = s[sent:]
                break


class FrameDecoder:
    """Incremental frame decoder for a byte stream.

    ``feed(data)`` returns every whole message that became available.  A
    partial frame simply waits for more bytes (torn frames are the normal
    state of a socket mid-read); corrupt input — CRC mismatch, a length
    over ``max_frame``, an unpicklable payload — raises
    :class:`ProtocolError` and poisons the decoder (the connection is
    dead; resynchronizing inside a corrupt pickle stream is hopeless).

    Buffer frames (``BUF_FLAG`` on the length word) carry raw bytes, not
    pickles: their payloads accumulate and are spliced into the *next*
    pickled message over its :class:`_WireBuf` placeholders.  A torn
    buffer frame flips the decoder into **fill mode** — the payload's
    final ``bytearray`` is allocated once and the owner pumps the socket
    straight into it (``wanted()`` / ``fill_view()`` / ``filled(n)``), so
    an 8 MiB array crosses the receive path with zero intermediate
    copies.  ``bytes_pickled`` / ``bytes_buffer`` count payload bytes by
    path, which is what the zero-copy conformance pin measures."""

    def __init__(self, max_frame: int = MAX_FRAME_LEN) -> None:
        self._buf = bytearray()
        self._max = max_frame
        self._poisoned = False
        self._bufs: List[Any] = []  # raw payloads awaiting their message
        self._fill: Optional[bytearray] = None  # torn buffer frame target
        self._fill_got = 0
        self._fill_crc = 0
        self.bytes_pickled = 0
        self.bytes_buffer = 0

    # ---- fill mode: recv_into the payload's final buffer -----------------
    def wanted(self) -> int:
        """Bytes the active torn-buffer-frame fill still needs (0: none)."""
        return 0 if self._fill is None else len(self._fill) - self._fill_got

    def fill_view(self) -> memoryview:
        """Writable view of the unfilled payload region — hand it to
        ``sock.recv_into`` and report the count via :meth:`filled`."""
        return memoryview(self._fill)[self._fill_got :]

    def filled(self, n: int) -> None:
        self._fill_got += n
        try:
            self._finish_fill()
        except ProtocolError:
            self._poisoned = True
            raise

    def _finish_fill(self) -> None:
        if self._fill is None or self._fill_got < len(self._fill):
            return
        if zlib.crc32(self._fill) != self._fill_crc:
            raise ProtocolError("buffer frame CRC mismatch")
        self.bytes_buffer += len(self._fill)
        self._bufs.append(self._fill)
        self._fill = None
        self._fill_got = 0

    # ---- stream feed ------------------------------------------------------
    def feed(self, data) -> List[Any]:
        if self._poisoned:
            raise ProtocolError("decoder poisoned by earlier corrupt frame")
        out: List[Any] = []
        try:
            if self._fill is not None:
                # Route bytes into the active fill first; residual bytes
                # (frames behind the buffer payload) fall through below.
                view = _as_byte_view(data)
                take = min(view.nbytes, len(self._fill) - self._fill_got)
                self._fill[self._fill_got : self._fill_got + take] = view[:take]
                self._fill_got += take
                self._finish_fill()
                if self._fill is not None:
                    return out
                data = view[take:]
            self._buf += data
            off = 0
            buf = self._buf
            hdr = _FRAME_HDR.size
            while len(buf) - off >= hdr:
                word, crc = _FRAME_HDR.unpack_from(buf, off)
                is_buffer = bool(word & BUF_FLAG)
                length = word & ~BUF_FLAG
                if length > self._max:
                    raise ProtocolError(
                        f"frame length {length} exceeds cap {self._max}"
                    )
                end = off + hdr + length
                if is_buffer and len(buf) < end:
                    # Torn buffer frame: allocate the final payload buffer
                    # and move whatever already arrived into it; the owner
                    # recv_intos the rest.
                    self._fill = target = bytearray(length)
                    got = len(buf) - off - hdr
                    target[:got] = buf[off + hdr :]
                    self._fill_got = got
                    self._fill_crc = crc
                    off = len(buf)
                    break
                if len(buf) < end:
                    break  # torn frame: wait for more bytes
                if is_buffer:
                    payload = bytearray(buf[off + hdr : end])
                    if zlib.crc32(payload) != crc:
                        raise ProtocolError("buffer frame CRC mismatch")
                    self.bytes_buffer += length
                    self._bufs.append(payload)
                    off = end
                    continue
                payload = bytes(buf[off + hdr : end])
                if zlib.crc32(payload) != crc:
                    raise ProtocolError("frame CRC mismatch")
                try:
                    msg = _wire_loads(payload)
                except ProtocolError:
                    raise
                except Exception as exc:
                    raise ProtocolError(f"undecodable frame payload: {exc!r}")
                self.bytes_pickled += length
                if self._bufs:
                    if isinstance(msg, UnresolvedMessage):
                        msg.msg = bind_buffers(msg.msg, self._bufs)
                    else:
                        msg = bind_buffers(msg, self._bufs)
                    self._bufs = []
                out.append(msg)
                off = end
        except ProtocolError:
            self._poisoned = True
            raise
        del self._buf[:off]
        return out


def parse_addr(address) -> Tuple[str, int]:
    """``"host:port"`` / ``(host, port)`` / ``"unix:/path"`` → ``(host,
    port)``.  A Unix-domain address keeps the whole ``unix:...`` string as
    the host (port 0) — same-host clusters skip the TCP stack entirely."""
    if isinstance(address, (tuple, list)):
        return str(address[0]), int(address[1])
    address = str(address)
    if address.startswith("unix:"):
        return address, 0
    host, _, port = address.rpartition(":")
    if not host:
        raise ValueError(f"address must be host:port or unix:/path, got {address!r}")
    return host, int(port)


def parse_shard_map(address) -> List[Tuple[str, int]]:
    """A single address → ``[(host, port)]``; a comma-joined string or a
    list of addresses → one endpoint per daemon.  Shard-map ORDER IS THE
    TOPOLOGY: it defines both the daemon hash ring and the global shard
    numbering, so every client of a cluster must use the same ordered
    map."""
    if isinstance(address, (tuple, list)):
        if (
            len(address) == 2
            and isinstance(address[0], str)
            and isinstance(address[1], int)
        ):
            return [parse_addr(address)]
        return [parse_addr(a) for a in address]
    address = str(address)
    if "," in address:
        return [parse_addr(a.strip()) for a in address.split(",") if a.strip()]
    return [parse_addr(address)]


def _encode_request(op: str, msg: tuple, buffers: List[memoryview]) -> List[Any]:
    """A request's frame segments; a request that does not pickle raises
    ``TypeError`` here, at the caller, before anything is sent."""
    try:
        return encode_wire_parts(msg, buffers)
    except (pickle.PicklingError, TypeError, AttributeError) as exc:
        raise TypeError(
            f"{op}: cannot send {_unpicklable(msg[-2:])!r} over the wire: every message is "
            "a standard pickle, so an eval function must be a module-level function or a "
            f"functools.partial of one ({exc})"
        ) from exc


class _Call:
    """One in-flight request: its encoded frame segments (kept for resend
    after a reconnect — the payload views stay valid because the caller
    blocks until the call completes), its completion state, and its
    private wake event — the pump wakes exactly the caller a response
    belongs to, never the herd."""

    __slots__ = ("parts", "done", "value", "error", "event")

    def __init__(self, parts: List[Any]) -> None:
        self.parts = parts
        self.done = False
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


def _dial(
    host: str,
    port: int,
    client_id: str,
    topics: Tuple[str, ...],
    timeout_s: float,
    *,
    zero_copy: bool = False,
) -> Tuple[socket.socket, Dict[str, Any], FrameDecoder, List[Any]]:
    """Connect + handshake: send ``sub``, block for ``hello``.  Returns the
    socket, the hello payload, the stream decoder (already fed), and any
    messages that arrived behind the hello."""
    if host.startswith("unix:"):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout_s)
        sock.connect(host[len("unix:"):])
    else:
        sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        if sock.family != socket.AF_UNIX:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(
            encode_wire(("sub", client_id, list(topics), {"zero_copy": bool(zero_copy)}))
        )
        dec = FrameDecoder()
        msgs: List[Any] = []
        while not msgs:
            data = sock.recv(1 << 16)
            if not data:
                raise OSError("server closed during handshake")
            msgs = dec.feed(data)
        hello = msgs[0]
        if not (isinstance(hello, tuple) and hello and hello[0] == "hello"):
            raise OSError(f"expected hello, got {hello!r}")
        sock.settimeout(None)
    except BaseException:
        sock.close()
        raise
    return sock, dict(hello[1]), dec, msgs[1:]


class _EventChannel:
    """The push plane: a second socket subscribed to watch topics, pumped
    by a background reader thread.  Kept separate from the request socket
    so the request path needs no reader-thread handoff (see
    :class:`NetClient`) while pushed wakes still arrive when the client is
    idle.  On connection loss it redials with bounded backoff and fires
    ``on_reconnect`` — waiters then re-probe, so no wake is ever lost to a
    server restart."""

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        topics: Tuple[str, ...],
        on_event: Callable[[tuple], None],
        on_reconnect: Optional[Callable[[dict], None]],
        on_hello: Callable[[dict], None],
        closed: threading.Event,
        *,
        connect_timeout_s: float,
        retry_max_s: float,
    ) -> None:
        self._host, self._port = host, port
        self._client_id = client_id
        self._topics = topics
        self._on_event = on_event
        self._on_reconnect = on_reconnect
        self._on_hello = on_hello
        self._closed = closed
        self._connect_timeout_s = connect_timeout_s
        self._retry_max_s = retry_max_s
        self.reconnects = 0
        self._sock, self.hello, self._decoder, backlog = _dial(
            host, port, client_id, topics, connect_timeout_s
        )
        on_hello(self.hello)
        for m in backlog:
            self._on_event(m)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"netkv-events-{port}"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._closed.is_set():
            try:
                data = self._sock.recv(1 << 16)
            except OSError:
                data = b""
            if data:
                try:
                    msgs = self._decoder.feed(data)
                except ProtocolError:
                    self._redial()
                    continue
                for m in msgs:
                    if not isinstance(m, UnresolvedMessage):  # events name no globals
                        self._on_event(m)
                continue
            if self._closed.is_set():
                return
            self._redial()

    def _redial(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        backoff = 0.005
        while not self._closed.is_set():
            try:
                self._sock, self.hello, self._decoder, backlog = _dial(
                    self._host,
                    self._port,
                    self._client_id,
                    self._topics,
                    self._connect_timeout_s,
                )
            except OSError:
                self._closed.wait(backoff)
                backoff = min(backoff * 2.0, self._retry_max_s)
                continue
            self.reconnects += 1
            self._on_hello(self.hello)
            # Resync: wake the owner's waiters with unknown keys — anything
            # may have happened (or a whole new server generation booted)
            # while this channel was down.
            if self._on_reconnect is not None:
                self._on_reconnect(self.hello)
            for m in backlog:
                self._on_event(m)
            return

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)


class NetClient:
    """A pipelined connection pair to a ``repro-kvd`` server.

    Thread-safe: any number of threads may :meth:`call` concurrently;
    requests interleave on the request socket and each caller blocks only
    on its own response.  Responses are demultiplexed *by the callers
    themselves* (leader/follower): whichever waiting caller holds the pump
    baton recvs and dispatches until its own response arrives, then hands
    the baton to a waiting follower.  On the hot path — one caller, answer
    already in flight — a response costs zero thread handoffs, which is
    what keeps a wire op in the same latency class as a local disk
    transaction.  Pushed watch events ride a separate
    :class:`_EventChannel` socket with a background reader, so wakes
    arrive even when no call is in flight.

    On connection loss the pumping caller redials with bounded backoff and
    re-sends every unacknowledged request in rid order (at-least-once —
    see the module docstring)."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        topics: Tuple[str, ...] = (),
        on_event: Optional[Callable[[tuple], None]] = None,
        on_reconnect: Optional[Callable[[dict], None]] = None,
        connect_timeout_s: float = 10.0,
        retry_max_s: float = 0.2,
        zero_copy: bool = True,
    ) -> None:
        self.host, self.port = host, port
        self.client_id = uuid.uuid4().hex
        self._connect_timeout_s = connect_timeout_s
        self._retry_max_s = retry_max_s
        self._zero_copy = bool(zero_copy)
        self._rid = itertools.count(1)
        self._pending: Dict[int, _Call] = {}
        self._state_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._pumping = False
        self._closed = threading.Event()
        self._req_reconnects = 0
        # Copied-vs-raw byte accounting for the request socket, both
        # directions; the conformance suite pins the zero-copy ratio on it.
        self._sent_pickled = 0
        self._sent_buffer = 0
        self._recv_pickled_base = 0
        self._recv_buffer_base = 0
        self.hello: Dict[str, Any] = {}
        # Every server generation this client was handed a hello by, in
        # order: a restart it talked to can never go uncounted, whichever
        # of its two sockets saw it first.
        self.generations: List[str] = []
        self._gen_lock = threading.Lock()
        deadline = time.monotonic() + connect_timeout_s
        backoff = 0.01
        while True:  # cover the race with a server that is still binding
            try:
                self._sock, self.hello, self._decoder, _ = _dial(
                    host,
                    port,
                    self.client_id,
                    (),
                    connect_timeout_s,
                    zero_copy=self._zero_copy,
                )
                self._saw(self.hello)
                break
            except OSError as exc:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"repro-kvd at {host}:{port} unreachable: {exc}"
                    ) from exc
                self._closed.wait(backoff)
                backoff = min(backoff * 2.0, retry_max_s)
        self._topics = tuple(topics)
        self._on_event = on_event
        self._on_reconnect = on_reconnect
        self._events: Optional[_EventChannel] = None
        self._events_lock = threading.Lock()

    def ensure_events(self) -> Optional[Dict[str, Any]]:
        """Dial the push channel if it is not up yet (it is lazy: a client
        that never waits never receives a single event frame).  Returns the
        channel's ``hello`` when this call created it — the caller must
        resync against its sequences, because anything that happened before
        this moment was never pushed — and ``None`` when it already ran."""
        if self._events is not None or not self._topics or self._on_event is None:
            return None
        with self._events_lock:
            if self._events is not None:
                return None
            channel = _EventChannel(
                self.host,
                self.port,
                self.client_id,
                self._topics,
                self._on_event,
                self._on_reconnect,
                self._saw,
                self._closed,
                connect_timeout_s=self._connect_timeout_s,
                retry_max_s=self._retry_max_s,
            )
            self._events = channel
            return dict(channel.hello)

    def _saw(self, hello: Dict[str, Any]) -> None:
        with self._gen_lock:
            if hello.get("gen") not in self.generations:
                self.generations.append(hello.get("gen"))

    @property
    def reconnects(self) -> int:
        return self._req_reconnects + (self._events.reconnects if self._events else 0)

    @property
    def bytes_pickled(self) -> int:
        """Payload bytes that crossed the request socket through the pickle
        codec, both directions.  With zero-copy on, a large array put/get
        moves almost everything through :attr:`bytes_buffer` instead —
        the structural pin behind the 'no copies through the codec'
        acceptance row."""
        return self._sent_pickled + self._recv_pickled_base + self._decoder.bytes_pickled

    @property
    def bytes_buffer(self) -> int:
        """Payload bytes that crossed the request socket as raw buffer
        frames (memoryview out, recv_into in), both directions."""
        return self._sent_buffer + self._recv_buffer_base + self._decoder.bytes_buffer

    # ---- request plane ---------------------------------------------------
    def call(self, op: str, *args: Any, **kwargs: Any) -> Any:
        return self.call_rid(op, *args, **kwargs)[1]

    def call_rid(self, op: str, *args: Any, **kwargs: Any) -> Tuple[int, Any]:
        """Issue one request; block for its response.  Returns ``(rid,
        value)`` — destructive reads use the rid as their server-side ack
        token.  Survives any number of reconnects in between; raises only
        a remapped server error or ``ConnectionError`` after close."""
        rid, call = self.start_call(op, *args, **kwargs)
        return rid, self.finish_call((rid, call))

    def start_call(self, op: str, *args: Any, **kwargs: Any) -> Tuple[int, _Call]:
        """Issue one request WITHOUT blocking for its response — the
        scatter half of a shard-map fan-out: a caller start_calls every
        daemon first, then :meth:`finish_call`\\ s each handle, so N
        daemons cost one round-trip of wall clock, not N."""
        if self._closed.is_set():
            raise ConnectionError("net client is closed")
        rid = next(self._rid)
        buffers: List[memoryview] = []
        if self._zero_copy and (op.startswith("kv.") or op.startswith("ob.")):
            args = extract_buffers(args, buffers)
            kwargs = extract_buffers(kwargs, buffers)
        parts = _encode_request(op, ("req", rid, op, args, kwargs), buffers)
        self._sent_pickled += len(parts[-1]) - _FRAME_HDR.size
        self._sent_buffer += sum(v.nbytes for v in buffers)
        call = _Call(parts)
        with self._state_lock:
            self._pending[rid] = call
            sock = self._sock
        if sock is not None:
            try:
                with self._send_lock:
                    _sendall_parts(sock, parts)
            except OSError:
                pass  # whoever pumps next redials and resends for us
        return rid, call

    def finish_call(self, handle: Tuple[int, _Call]) -> Any:
        """Block for a :meth:`start_call` handle's response; returns the
        value or raises the remapped server error."""
        _rid, call = handle
        self._await(call)
        if call.error is not None:
            raise call.error
        return call.value

    def cast(self, op: str, *args: Any, **kwargs: Any) -> None:
        """Fire-and-forget: one frame out, no response, no await.  For
        advisory writes (duration samples, counters) where the caller needs
        neither the result nor a delivery guarantee stronger than the
        socket's — a cast lost to a reconnect window is simply dropped
        (requests, by contrast, are resent).  Ordering relative to this
        client's own later calls is preserved (same socket, in-order
        server)."""
        if self._closed.is_set():
            raise ConnectionError("net client is closed")
        buffers: List[memoryview] = []
        if self._zero_copy and (op.startswith("kv.") or op.startswith("ob.")):
            args = extract_buffers(args, buffers)
            kwargs = extract_buffers(kwargs, buffers)
        parts = _encode_request(op, ("cast", op, args, kwargs), buffers)
        self._sent_pickled += len(parts[-1]) - _FRAME_HDR.size
        self._sent_buffer += sum(v.nbytes for v in buffers)
        with self._state_lock:
            sock = self._sock
        if sock is not None:
            try:
                with self._send_lock:
                    _sendall_parts(sock, parts)
            except OSError:
                pass  # best-effort: advisory write dropped with the conn

    def _await(self, call: _Call) -> None:
        """Leader/follower pump with targeted wakes: become the socket
        reader if nobody is, else sleep on this call's PRIVATE event.
        Completing a response wakes exactly its caller; a leader whose own
        call finished hands the baton by waking one pending caller, who
        then takes over the pump.  Under concurrent callers this costs one
        context switch per response — never a broadcast herd."""
        while not call.done:
            lead = False
            with self._state_lock:
                if call.done:
                    break
                if self._closed.is_set():
                    call.error = call.error or ConnectionError("net client closed")
                    call.done = True
                    break
                if not self._pumping:
                    self._pumping = lead = True
            if not lead:
                call.event.wait(1.0)  # bounded: baton races resolve in <1s
                call.event.clear()
                continue
            try:
                while not call.done and not self._closed.is_set():
                    self._pump_once()
            finally:
                with self._state_lock:
                    self._pumping = False
                    if self._closed.is_set() and not call.done:
                        call.error = call.error or ConnectionError(
                            "net client closed"
                        )
                        call.done = True
                    # Hand the baton over: wake ONE pending caller, who
                    # becomes the next leader (or finds itself done).
                    nxt = next(iter(self._pending.values()), None)
                if nxt is not None:
                    nxt.event.set()

    def _pump_once(self) -> None:
        sock = self._sock
        if sock is None:
            self._redial_and_resend()
            return
        dec = self._decoder
        data = None
        try:
            if dec.wanted():
                # Mid-buffer-frame: recv straight into the payload's final
                # bytearray — a large array get lands with zero copies.
                got = sock.recv_into(dec.fill_view())
            else:
                data = sock.recv(1 << 16)
                got = len(data)
        except OSError:
            got = 0
        if not got:
            if self._closed.is_set():
                return
            self._redial_and_resend()
            return
        try:
            if data is None:
                dec.filled(got)  # buffer bytes only: no message completes
                msgs: List[Any] = []
            else:
                msgs = dec.feed(data)
        except ProtocolError:
            # A server speaking garbage is indistinguishable from a
            # corrupted stream: drop the connection and resync fresh.
            self._redial_and_resend()
            return
        for m in msgs:
            self._dispatch(m)

    def _dispatch(self, m: Any) -> bool:
        unresolved = m if isinstance(m, UnresolvedMessage) else None
        if unresolved is not None:
            m = unresolved.msg
        kind = m[0]
        if kind not in ("res", "err"):
            return False
        with self._state_lock:
            call = self._pending.pop(m[1], None)
        if call is None:
            return False
        if unresolved is not None:
            call.error = TypeError(f"response to request {m[1]}: {unresolved.describe()}")
        elif kind == "res":
            call.value = m[2]
        else:
            call.error = self._map_error(m[2], m[3])
        call.done = True
        call.event.set()  # targeted: wake this caller alone
        return True

    @staticmethod
    def _map_error(etype: str, msg: str) -> Exception:
        if etype == "KeyError":
            return KeyError(msg)
        if etype == "FileNotFoundError":
            return FileNotFoundError(msg)
        return RemoteError(etype, msg)

    def _redial_and_resend(self) -> None:
        """Leader-only: redial after a lost connection, then resend the
        whole unacknowledged window in rid order."""
        with self._state_lock:
            old, self._sock = self._sock, None
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        backoff = 0.005
        while not self._closed.is_set():
            try:
                sock, self.hello, decoder, backlog = _dial(
                    self.host,
                    self.port,
                    self.client_id,
                    (),
                    self._connect_timeout_s,
                    zero_copy=self._zero_copy,
                )
            except OSError:
                self._closed.wait(backoff)
                backoff = min(backoff * 2.0, self._retry_max_s)
                continue
            # Fold the dead decoder's byte counters into the running totals
            # before dropping it — accounting survives reconnects.
            self._recv_pickled_base += self._decoder.bytes_pickled
            self._recv_buffer_base += self._decoder.bytes_buffer
            self._decoder = decoder
            with self._state_lock:
                self._sock = sock
                pending = sorted(self._pending.items())
            try:
                with self._send_lock:
                    for _rid, call in pending:
                        _sendall_parts(sock, call.parts)
            except OSError:
                continue  # lost it again mid-resend: start over
            self._req_reconnects += 1
            self._saw(self.hello)
            for m in backlog:
                self._dispatch(m)
            return

    def close(self) -> None:
        self._closed.set()
        with self._state_lock:
            sock, self._sock = self._sock, None
            pending = list(self._pending.values())
            self._pending.clear()
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for call in pending:
            if not call.done:
                call.error = ConnectionError("net client closed")
                call.done = True
            call.event.set()
        if self._events is not None:
            self._events.close()


class NetKVStore(KVStore):
    """:class:`KVStore` over a ``repro-kvd`` connection.

    Same public API, same notification contract, same charging model:
    every verb is one wire frame, charged locally with the in-memory
    store's exact formulas (one amortized round-trip per shard touched
    for batched verbs), so ledgers compare across backends.  The local
    shard structs hold no data — they carry the watch conditions, the
    keyed-wake ring (fed by pushed ``("kv", shard, seq, keys)`` events),
    and the op stats.

    Waiting is fully event-driven and *registered*: ``wait_key`` /
    ``blpop`` pin a per-key watch on the server (refcounted; one wire op
    per wait session, none per loop iteration), and the server pushes
    wake frames only for watched keys — the keyed-wake filter runs
    server-side, so the torrent of unwatched control-plane writes never
    crosses the wire at all.  Registration replies with the key's current
    server shard sequence; a mismatch with the last sequence this client
    saw means writes landed while unwatched, and the shard is woken once
    so the caller re-probes — the snapshot-check-wait contract holds with
    no lost wakes and no fallback ticks."""

    def __init__(
        self,
        address,
        profile: StorageProfile = REDIS_2017,
        ledger: Optional[Ledger] = None,
        *,
        connect_timeout_s: float = 10.0,
        zero_copy: bool = True,
    ) -> None:
        self._addrs = parse_shard_map(address)
        # Pop-ack and watch bookkeeping must exist before any event can
        # arrive.
        self._ack_guard = threading.Lock()
        self._pop_acks: Dict[str, List[int]] = {}
        self._watch_lock = threading.Lock()
        self._watch_refs: Dict[str, int] = {}
        # One connection pair per daemon, each with its own reconnect loop
        # and event closures bound to its daemon index.  The global shard
        # space concatenates the daemons' shards in shard-map order.
        self._clients: List[NetClient] = []
        self._shard_base: List[int] = []
        self._daemon_shards: List[int] = []
        self._srv_seqs: Dict[int, int] = {}
        base = 0
        for d, (host, port) in enumerate(self._addrs):
            self._shard_base.append(base)
            self._daemon_shards.append(0)  # closure-safe until hello lands
            client = NetClient(
                host,
                port,
                topics=("kv",),
                on_event=self._make_on_event(d),
                on_reconnect=self._make_on_reconnect(d),
                connect_timeout_s=connect_timeout_s,
                zero_copy=zero_copy,
            )
            self._clients.append(client)
            n = int(client.hello["num_shards"])
            self._daemon_shards[d] = n
            for i, seq in enumerate(client.hello.get("kv_seqs", [])):
                self._srv_seqs[base + i] = seq
            base += n
        super().__init__(num_shards=base, profile=profile, ledger=ledger)

    # ---- shard-map routing ----------------------------------------------
    @property
    def _client(self) -> NetClient:
        """The first daemon's client — the whole client for an N=1 map.
        Kept as the single-daemon compatibility surface (examples and
        tests reach for ``kv._client.reconnects``)."""
        return self._clients[0]

    def _daemon_of(self, key: str) -> int:
        return _daemon_of(key, len(self._clients))

    def _client_for(self, key: str) -> NetClient:
        return self._clients[self._daemon_of(key)]

    def shard_of(self, key: str) -> int:
        # Daemon first, then the daemon-local shard (the same crc32 the
        # server itself routes by), offset into the global space.  N=1
        # degenerates to exactly the base class hash.
        d = self._daemon_of(key)
        return self._shard_base[d] + zlib.crc32(key.encode()) % self._daemon_shards[d]

    def _fanout(self, op: str, per_daemon: Dict[int, tuple]) -> Dict[int, Any]:
        """One ``op`` frame per daemon, pipelined: every request leaves
        before any response is awaited, so a shard-map scatter costs one
        round-trip of wall clock."""
        handles = [
            (d, self._clients[d].start_call(op, *args))
            for d, args in per_daemon.items()
        ]
        return {d: self._clients[d].finish_call(h) for d, h in handles}

    # ---- endpoint --------------------------------------------------------
    def _endpoint_spec(self) -> Dict[str, Any]:
        return {
            "kind": "net_kv",
            "addr": ",".join(_addr_str(a) for a in self._addrs),
        }

    def close(self) -> None:
        for client in self._clients:
            client.close()

    # ---- pushed watch events --------------------------------------------
    def _make_on_event(self, d: int) -> Callable[[tuple], None]:
        """Event callback for daemon ``d``: remaps its local shard index
        into the global shard space and touches only that shard."""

        def on_event(m: tuple) -> None:
            if m[0] != "kv":
                return
            shards = getattr(self, "_shards", None)
            if shards is None:
                return  # event raced construction: no waiters exist yet
            _kind, sidx, srv_seq, keys = m
            if not (0 <= sidx < self._daemon_shards[d]):
                return
            g = self._shard_base[d] + sidx
            self._srv_seqs[g] = max(self._srv_seqs.get(g, 0), srv_seq)
            sh = shards[g]
            with sh.lock:
                sh.touch(keys)

        return on_event

    def _make_on_reconnect(self, d: int) -> Callable[[dict], None]:
        """Reconnect handler for daemon ``d`` ALONE: re-pins only the
        watches that route to it, adopts only its shard sequences, wakes
        only its shards' waiters.  The other daemons' connections are
        untouched — a one-daemon outage never disturbs the survivors."""

        def on_reconnect(hello: dict) -> None:
            shards = getattr(self, "_shards", None)
            if shards is None:
                return
            # Order matters: re-pin every live watch FIRST (a write landing
            # between hello and re-registration must not go unpushed), THEN
            # adopt the hello sequences, THEN wake every waiter with UNKNOWN
            # keys so each re-probes its predicate exactly once.  A restarted
            # server starts a new generation with fresh sequences, so this is
            # an assignment, not a max.
            with self._watch_lock:
                live = [k for k, n in self._watch_refs.items() if n > 0]
                for key in live:
                    if self._daemon_of(key) != d:
                        continue
                    try:
                        self._clients[d].call("watch.kv", key, True)
                    except (ConnectionError, OSError):
                        pass  # next reconnect re-registers again
            base = self._shard_base[d]
            for i, seq in enumerate(hello.get("kv_seqs", [])):
                self._srv_seqs[base + i] = seq
            for i in range(self._daemon_shards[d]):
                sh = shards[base + i]
                with sh.lock:
                    sh.touch(None)

        return on_reconnect

    # ---- registered waits ------------------------------------------------
    def _watch_acquire(self, key: str) -> None:
        """Pin a server-side watch on ``key`` (refcounted: one wire op per
        wait session).  The registration reply carries the key's current
        server shard sequence; if it differs from the last sequence this
        client saw, writes landed while unwatched — touch the shard so the
        caller's predicate re-check runs before it sleeps.

        The lock is held ACROSS the wire op: an "on" racing a concurrent
        "off" for the same key could otherwise land first and leave the
        server unwatched under a sleeping waiter."""
        d = self._daemon_of(key)
        client = self._clients[d]
        base = self._shard_base[d]
        with self._watch_lock:
            n = self._watch_refs.get(key, 0)
            self._watch_refs[key] = n + 1
            if n:
                return
            try:
                hello = client.ensure_events()
                if hello is not None:
                    # The event channel was just created: writes before it
                    # existed were never pushed.  Adopt its hello seqs;
                    # mismatched shards wake with unknown keys.  Only this
                    # daemon's shards are involved — the hello speaks for
                    # one daemon.
                    stale = []
                    for i, srv_seq in enumerate(hello.get("kv_seqs", [])):
                        if srv_seq != self._srv_seqs.get(base + i, 0):
                            stale.append(base + i)
                        self._srv_seqs[base + i] = srv_seq
                    for g in stale:
                        sh = self._shards[g]
                        with sh.lock:
                            sh.touch(None)
                srv_seq = int(client.call("watch.kv", key, True))
            except BaseException:
                self._watch_refs[key] = n  # registration failed: unwind
                if not n:
                    self._watch_refs.pop(key, None)
                raise
            sidx = self.shard_of(key)
            if srv_seq != self._srv_seqs.get(sidx, 0):
                self._srv_seqs[sidx] = srv_seq
                sh = self._shards[sidx]
                with sh.lock:
                    sh.touch((key,))

    def _watch_release(self, key: str) -> None:
        with self._watch_lock:
            n = self._watch_refs.get(key, 0) - 1
            if n > 0:
                self._watch_refs[key] = n
                return
            self._watch_refs.pop(key, None)
            try:
                self._client_for(key).call("watch.kv", key, False)
            except (ConnectionError, OSError, RemoteError):
                pass  # conn gone: the server reaps the watch with it

    def wait_key(self, key: str, last_seq: int, timeout_s: float) -> int:
        self._watch_acquire(key)
        try:
            return super().wait_key(key, last_seq, timeout_s)
        finally:
            self._watch_release(key)

    # ---- atomic single-key ops ------------------------------------------
    def set(self, key: str, value: Any, *, worker: str = "-") -> None:
        self._client_for(key).call("kv.set", key, value)
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "set", key, _sizeof(value), write=True)

    def get(self, key: str, default: Any = None, *, worker: str = "-") -> Any:
        value = self._client_for(key).call("kv.get", key, default)
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "get", key, _sizeof(value), write=False)
        return value

    def _group_keys(self, keys) -> Dict[int, List[int]]:
        """Input positions grouped by owning daemon (shard-map scatter)."""
        by_daemon: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            by_daemon.setdefault(self._daemon_of(key), []).append(i)
        return by_daemon

    def mget(
        self, keys: List[str], default: Any = None, *, worker: str = "-"
    ) -> List[Any]:
        keys = list(keys)
        if len(self._clients) == 1:
            out = self._client.call("kv.mget", keys, default)
        else:
            by_daemon = self._group_keys(keys)
            parts = self._fanout(
                "kv.mget",
                {d: ([keys[i] for i in idxs], default) for d, idxs in by_daemon.items()},
            )
            out: List[Any] = [default] * len(keys)
            for d, idxs in by_daemon.items():
                for i, v in zip(idxs, parts[d]):
                    out[i] = v
        by_shard: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self.shard_of(key), []).append(i)
        for sidx, positions in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = sum(_sizeof(out[i]) for i in positions)
                self._charge(
                    sh, worker, "mget", f"[{len(positions)} keys@s{sidx}]",
                    nbytes, write=False,
                )
        return out

    def mset(self, mapping: Dict[str, Any], *, worker: str = "-") -> None:
        if len(self._clients) == 1:
            self._client.call("kv.mset", dict(mapping))
        else:
            per_daemon: Dict[int, Dict[str, Any]] = {}
            for key, value in mapping.items():
                per_daemon.setdefault(self._daemon_of(key), {})[key] = value
            self._fanout("kv.mset", {d: (m,) for d, m in per_daemon.items()})
        by_shard: Dict[int, List[str]] = {}
        for key in mapping:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = sum(_sizeof(mapping[key]) for key in group)
                self._charge(
                    sh, worker, "mset", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )

    def setnx(self, key: str, value: Any, *, worker: str = "-") -> bool:
        won = bool(self._client_for(key).call("kv.setnx", key, value))
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "setnx", key, _sizeof(value), write=True)
        return won

    def incr(self, key: str, amount: float = 1, *, worker: str = "-") -> float:
        new = self._client_for(key).call("kv.incr", key, amount)
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "incr", key, 8, write=True)
        return new

    def cas(self, key: str, expect: Any, value: Any, *, worker: str = "-") -> bool:
        won = bool(self._client_for(key).call("kv.cas", key, expect, value))
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "cas", key, _sizeof(value), write=True)
        return won

    def delete(self, key: str, *, worker: str = "-") -> None:
        self._client_for(key).call("kv.delete", key)
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "del", key, 0, write=True)

    def mdel(self, keys: List[str], *, worker: str = "-") -> int:
        keys = list(keys)
        if len(self._clients) == 1:
            removed = int(self._client.call("kv.mdel", keys))
        else:
            by_daemon = self._group_keys(keys)
            parts = self._fanout(
                "kv.mdel",
                {d: ([keys[i] for i in idxs],) for d, idxs in by_daemon.items()},
            )
            removed = sum(int(v) for v in parts.values())
        by_shard: Dict[int, List[str]] = {}
        for key in keys:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                self._charge(
                    sh, worker, "mdel", f"[{len(group)} keys@s{sidx}]", 0, write=True
                )
        return removed

    def exists(self, key: str, *, worker: str = "-") -> bool:
        ok = bool(self._client_for(key).call("kv.exists", key))
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "exists", key, 0, write=False)
        return ok

    def scan(self, prefix: str, *, worker: str = "-") -> List[str]:
        # A prefix scatters across every daemon's keyspace: fan to all,
        # union (pipelined — one round-trip of wall clock).
        parts = self._fanout(
            "kv.scan", {d: (prefix,) for d in range(len(self._clients))}
        )
        found: List[str] = []
        for vals in parts.values():
            found.extend(vals)
        per_shard: Dict[int, int] = {}
        for k in found:
            sidx = self.shard_of(k)
            per_shard[sidx] = per_shard.get(sidx, 0) + len(k.encode())
        # Same formula as the in-memory scan: every shard is charged a
        # round-trip (hashing scatters a prefix across all of them).
        for sh in self._shards:
            with sh.lock:
                self._charge(
                    sh, worker, "scan", f"[{prefix}*@s{sh.idx}]",
                    per_shard.get(sh.idx, 0), write=False,
                )
        return sorted(found)

    # ---- server-side scripting ------------------------------------------
    def eval(
        self,
        key: str,
        fn: Callable[[Any], Any],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Any:
        old = self._client_for(key).call("kv.eval", key, fn, default)
        new = fn(old)  # deterministic replay: side effects land HERE
        deleted = new is DELETE
        sh = self._shard(key)
        with sh.lock:
            self._charge(
                sh, worker, "eval", key, 0 if deleted else _sizeof(new), write=True
            )
        return None if deleted else new

    def eval_many(
        self,
        updates: Dict[str, Callable[[Any], Any]],
        *,
        default: Any = None,
        worker: str = "-",
    ) -> Dict[str, Any]:
        if len(self._clients) == 1:
            olds = self._client.call("kv.eval_many", dict(updates), default)
        else:
            per_daemon: Dict[int, Dict[str, Callable[[Any], Any]]] = {}
            for key, fn in updates.items():
                per_daemon.setdefault(self._daemon_of(key), {})[key] = fn
            olds = {}
            for part in self._fanout(
                "kv.eval_many", {d: (m, default) for d, m in per_daemon.items()}
            ).values():
                olds.update(part)
        by_shard: Dict[int, List[str]] = {}
        for key in updates:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        out: Dict[str, Any] = {}
        for sidx, group in by_shard.items():
            nbytes = 0
            for key in group:
                new = updates[key](olds[key])  # deterministic replay
                if new is DELETE:
                    out[key] = None
                    continue
                out[key] = new
                nbytes += _sizeof(new)
            sh = self._shards[sidx]
            with sh.lock:
                self._charge(
                    sh, worker, "meval", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )
        return out

    # ---- lists (queues) --------------------------------------------------
    def rpush(self, key: str, *values: Any, worker: str = "-") -> int:
        length = int(self._client_for(key).call("kv.rpush", key, *values))
        sh = self._shard(key)
        with sh.lock:
            self._charge(
                sh, worker, "rpush", key, sum(_sizeof(v) for v in values), write=True
            )
        return length

    def rpush_nowait(self, key: str, *values: Any, worker: str = "-") -> None:
        self._client_for(key).cast("kv.rpush", key, *values)
        sh = self._shard(key)
        with sh.lock:
            self._charge(
                sh, worker, "rpush", key, sum(_sizeof(v) for v in values), write=True
            )

    def rpush_many(
        self, pushes: Dict[str, List[Any]], *, worker: str = "-"
    ) -> Dict[str, int]:
        if len(self._clients) == 1:
            lengths = self._client.call("kv.rpush_many", dict(pushes))
        else:
            per_daemon: Dict[int, Dict[str, List[Any]]] = {}
            for key, values in pushes.items():
                per_daemon.setdefault(self._daemon_of(key), {})[key] = values
            lengths = {}
            for part in self._fanout(
                "kv.rpush_many", {d: (m,) for d, m in per_daemon.items()}
            ).values():
                lengths.update(part)
        by_shard: Dict[int, List[str]] = {}
        for key in pushes:
            by_shard.setdefault(self.shard_of(key), []).append(key)
        for sidx, group in by_shard.items():
            sh = self._shards[sidx]
            with sh.lock:
                nbytes = sum(_sizeof(v) for key in group for v in pushes[key])
                self._charge(
                    sh, worker, "mrpush", f"[{len(group)} keys@s{sidx}]",
                    nbytes, write=True,
                )
        return lengths

    def _pop_wire(self, key: str, max_n: int) -> List[Any]:
        """One ack-journaled destructive read (module docstring: a retried
        pop must return the FIRST pop's items, never pop again)."""
        with self._ack_guard:
            acked = self._pop_acks.pop(key, None) or []
        try:
            rid, out = self._client_for(key).call_rid("kv.lpop_n", key, max_n, acked)
        except BaseException:
            if acked:  # put the retirement list back for the next attempt
                with self._ack_guard:
                    self._pop_acks.setdefault(key, []).extend(acked)
            raise
        if out:
            with self._ack_guard:
                self._pop_acks.setdefault(key, []).append(rid)
        return out

    def lpop(self, key: str, *, worker: str = "-") -> Any:
        out = self._pop_wire(key, 1)
        value = out[0] if out else None
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "lpop", key, _sizeof(value), write=True)
        return value

    def lpop_n(self, key: str, max_n: int, *, worker: str = "-") -> List[Any]:
        out = self._pop_wire(key, max_n)
        sh = self._shard(key)
        with sh.lock:
            self._charge(
                sh, worker, "lpopn", key, sum(_sizeof(v) for v in out), write=True
            )
        return out

    def blpop(self, key: str, timeout_s: float, *, worker: str = "-") -> Any:
        """Event-driven blocking pop: wire attempt, then wait on the local
        shard condition for a pushed wake naming ``key``.  The sequence is
        snapshotted BEFORE each attempt, so a push whose event lands after
        a failed attempt wakes the wait instead of being missed."""
        deadline = time.monotonic() + timeout_s
        sh = self._shard(key)
        # One watch session spans every retry: the inner wait_key calls
        # refcount onto this pin instead of churning the wire per loop.
        self._watch_acquire(key)
        try:
            while True:
                with sh.lock:
                    seq = sh.seq
                out = self._pop_wire(key, 1)
                if out:
                    with sh.lock:
                        self._charge(
                            sh, worker, "blpop", key, _sizeof(out[0]), write=True
                        )
                    return out[0]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self.wait_key(key, seq, remaining)
        finally:
            self._watch_release(key)

    def lrange(
        self, key: str, start: int = 0, stop: int = -1, *, worker: str = "-"
    ) -> List[Any]:
        out = self._client_for(key).call("kv.lrange", key, start, stop)
        sh = self._shard(key)
        with sh.lock:
            self._charge(
                sh, worker, "lrange", key, sum(_sizeof(v) for v in out), write=False
            )
        return out

    def llen(self, key: str, *, worker: str = "-") -> int:
        n = int(self._client_for(key).call("kv.llen", key))
        sh = self._shard(key)
        with sh.lock:
            self._charge(sh, worker, "llen", key, 8, write=False)
        return n


class NetBackend(_Backend):
    """Object-store backend over a ``repro-kvd`` connection.

    Byte-plane ops are one frame each (batched verbs stay batched); the
    watch plane is fully pushed — the server streams ``("obj", seq,
    keys)`` events for every mutation *including this client's own*
    (``echoes_puts``), feeding the inherited ``puts_since`` ring, so
    ``ObjectStore.wait_keys`` is event-driven with zero fallback ticks."""

    cross_process = True
    self_watching = True
    echoes_puts = True
    # The server consumes put blobs synchronously (logged before the res
    # frame), so callers may hand over live memoryviews without aliasing —
    # checkpoint.save skips its tobytes() copy on this signal.
    zero_copy_puts = True

    def __init__(
        self, address, *, connect_timeout_s: float = 10.0, zero_copy: bool = True
    ) -> None:
        self._addrs = parse_shard_map(address)
        self._zero_copy = bool(zero_copy)
        self._init_watch()
        self._clients: List[NetClient] = []
        self._srv_obj_seqs: Dict[int, int] = {}
        for d, (host, port) in enumerate(self._addrs):
            client = NetClient(
                host,
                port,
                topics=("obj",),
                on_event=self._make_on_event(d),
                on_reconnect=self._make_on_reconnect(d),
                connect_timeout_s=connect_timeout_s,
                zero_copy=zero_copy,
            )
            self._clients.append(client)
            self._srv_obj_seqs[d] = int(client.hello.get("obj_seq", 0))

    # ---- shard-map routing ----------------------------------------------
    @property
    def _client(self) -> NetClient:
        """First daemon's client — the whole client for an N=1 map (the
        single-daemon compatibility surface)."""
        return self._clients[0]

    def _daemon_of(self, key: str) -> int:
        return _daemon_of(key, len(self._clients))

    def _client_for(self, key: str) -> NetClient:
        return self._clients[self._daemon_of(key)]

    def _fanout(self, op: str, per_daemon: Dict[int, tuple]) -> Dict[int, Any]:
        handles = [
            (d, self._clients[d].start_call(op, *args))
            for d, args in per_daemon.items()
        ]
        return {d: self._clients[d].finish_call(h) for d, h in handles}

    def endpoint_spec(self) -> Dict[str, Any]:
        return {
            "kind": "net_obj",
            "addr": ",".join(_addr_str(a) for a in self._addrs),
        }

    def close(self) -> None:
        for client in self._clients:
            client.close()

    # ---- pushed watch events --------------------------------------------
    def _make_on_event(self, d: int) -> Callable[[tuple], None]:
        def on_event(m: tuple) -> None:
            if m[0] == "obj":
                self._srv_obj_seqs[d] = max(self._srv_obj_seqs.get(d, 0), int(m[1]))
                _Backend.notify_put(self, m[2])

        return on_event

    def _make_on_reconnect(self, d: int) -> Callable[[dict], None]:
        def on_reconnect(hello: dict) -> None:
            # Unknown-keys wake: waiters re-probe once, so no put that
            # landed while daemon ``d`` was unreachable can be missed.  New
            # generation means fresh server sequences — adopt, don't max.
            # Only this daemon's sequence resets; the survivors' event
            # streams never paused.
            self._srv_obj_seqs[d] = int(hello.get("obj_seq", 0))
            _Backend.notify_put(self, None)

        return on_reconnect

    def wait_put(self, last_seq: int, timeout_s: float) -> int:
        # The event channels are lazy (non-waiting clients pay zero event
        # CPU); first wait creates them — on every daemon, since a put may
        # land anywhere in the map.  Each hello carries that daemon's
        # current object sequence — any gap vs the last sequence we saw is
        # a put that predates the channel, so wake with unknown keys.
        for d, client in enumerate(self._clients):
            hello = client.ensure_events()
            if hello is not None:
                srv = int(hello.get("obj_seq", 0))
                if srv != self._srv_obj_seqs.get(d, 0):
                    self._srv_obj_seqs[d] = srv
                    _Backend.notify_put(self, None)
        return _Backend.wait_put(self, last_seq, timeout_s)

    # ---- byte plane ------------------------------------------------------
    def _wire_blob(self, blob) -> Any:
        """Large bytes-likes ride buffer frames untouched; everything else
        (and everything when zero-copy is off) normalizes to ``bytes`` so
        the pickled fallback path always round-trips."""
        if self._zero_copy and isinstance(blob, (bytes, bytearray, memoryview)):
            return blob
        return bytes(blob)

    def put(self, key: str, blob: bytes, *, if_absent: bool) -> bool:
        return bool(
            self._client_for(key).call("ob.put", key, self._wire_blob(blob), if_absent)
        )

    def put_many(self, items: Dict[str, bytes], *, if_absent: bool) -> int:
        if len(self._clients) == 1:
            return int(
                self._client.call(
                    "ob.put_many",
                    {k: self._wire_blob(b) for k, b in items.items()},
                    if_absent,
                )
            )
        per_daemon: Dict[int, Dict[str, Any]] = {}
        for key, blob in items.items():
            per_daemon.setdefault(self._daemon_of(key), {})[key] = self._wire_blob(blob)
        parts = self._fanout(
            "ob.put_many", {d: (m, if_absent) for d, m in per_daemon.items()}
        )
        return sum(int(v) for v in parts.values())

    def get(self, key: str) -> bytes:
        return self._client_for(key).call("ob.get", key)

    def get_many(self, keys: List[str]) -> Dict[str, bytes]:
        if len(self._clients) == 1:
            return self._client.call("ob.get_many", list(keys))
        per_daemon: Dict[int, List[str]] = {}
        for key in keys:
            per_daemon.setdefault(self._daemon_of(key), []).append(key)
        out: Dict[str, bytes] = {}
        for part in self._fanout(
            "ob.get_many", {d: (ks,) for d, ks in per_daemon.items()}
        ).values():
            out.update(part)
        return out

    def exists(self, key: str) -> bool:
        return bool(self._client_for(key).call("ob.exists", key))

    def exists_many(self, keys: List[str]) -> set:
        if len(self._clients) == 1:
            return set(self._client.call("ob.exists_many", list(keys)))
        per_daemon: Dict[int, List[str]] = {}
        for key in keys:
            per_daemon.setdefault(self._daemon_of(key), []).append(key)
        out: set = set()
        for part in self._fanout(
            "ob.exists_many", {d: (ks,) for d, ks in per_daemon.items()}
        ).values():
            out.update(part)
        return out

    def delete(self, key: str) -> None:
        self._client_for(key).call("ob.delete", key)

    def list(self, prefix: str) -> List[str]:
        out: List[str] = []
        for part in self._fanout(
            "ob.list", {d: (prefix,) for d in range(len(self._clients))}
        ).values():
            out.extend(part)
        return out
