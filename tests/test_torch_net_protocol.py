"""The port's ``repro-kvd`` wire (`repro_torch.storage.net_kv` /
`net_server`) under the JAX package's fuzz and adversarial-input suite
(`tests/test_net_protocol.py`), plus the shared wire: frames either
package's codec writes decode with the other's under any chunking, plain
frames are byte-equal, and a frame naming what the port cannot resolve is
refused by name.

Two layers:

  * **Codec** — ``encode_wire`` / ``FrameDecoder`` round-trip under every
    byte-boundary split (torn frames are the normal state of a socket
    mid-read), plus crafted corruption: truncated headers, CRC flips,
    oversized length claims, garbage payloads.  Property-based cases run
    when ``hypothesis`` is installed and skip cleanly when it is not (the
    crafted cases below cover the same invariants deterministically).
  * **Live server** — a real ``KVDServer`` fed malformed bytes on a raw
    socket.  The contract: malformed input is a clean *per-connection*
    error.  The offending connection is closed; every other client keeps
    working; a half-sent pipeline applies nothing.
"""

import socket
import struct
import time
import zlib

import pytest

pytest.importorskip("torch")

from repro_torch.storage import NetKVStore  # noqa: E402
from repro_torch.storage.kv_store import _FRAME_HDR  # noqa: E402
from repro_torch.storage.net_kv import (  # noqa: E402
    MAX_FRAME_LEN,
    ZERO_COPY_MIN,
    FrameDecoder,
    ProtocolError,
    encode_wire,
    encode_wire_parts,
    extract_buffers,
    parse_addr,
    parse_shard_map,
)
from repro_torch.storage.net_server import KVDServer  # noqa: E402


# ---------------------------------------------------------------------------
# codec: round-trip
# ---------------------------------------------------------------------------

_SAMPLES = [
    ("req", 1, "kv.set", ("k", {"v": [1, 2, 3]}), {}),
    ("res", 7, None),
    ("err", 7, "KeyError", "missing"),
    ("kv", 3, 42, ("a", "b")),
    ("cast", "kv.rpush", ("durs", 0.5), {}),
    ("sub", "client-1", ("kv", "obj")),
    (),
    ("res", 0, b"\x00" * 4096),
]


def test_roundtrip_single_frames():
    for msg in _SAMPLES:
        dec = FrameDecoder()
        assert dec.feed(encode_wire(msg)) == [msg]


def test_roundtrip_pipelined_and_torn():
    """All sample frames concatenated, then fed one byte at a time — every
    possible tear point.  Each message pops out exactly once, in order."""
    blob = b"".join(encode_wire(m) for m in _SAMPLES)
    dec = FrameDecoder()
    out = []
    for i in range(len(blob)):
        out.extend(dec.feed(blob[i : i + 1]))
    assert out == _SAMPLES


def test_roundtrip_random_chunking():
    """Same pipeline under irregular chunk sizes (a socket's recv returns
    arbitrary prefixes)."""
    blob = b"".join(encode_wire(m) for m in _SAMPLES)
    for step in (2, 3, 7, 64, 1000, len(blob)):
        dec = FrameDecoder()
        out = []
        for off in range(0, len(blob), step):
            out.extend(dec.feed(blob[off : off + step]))
        assert out == _SAMPLES, f"chunk size {step}"


def test_hypothesis_roundtrip_any_object_any_chunking():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    values = st.recursive(
        st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False)
        | st.text() | st.binary(),
        lambda children: st.lists(children) | st.tuples(children, children)
        | st.dictionaries(st.text(), children),
        max_leaves=20,
    )

    @hyp.given(msgs=st.lists(values, max_size=6), chunk=st.integers(1, 97))
    @hyp.settings(max_examples=200, deadline=None)
    def check(msgs, chunk):
        blob = b"".join(encode_wire(m) for m in msgs)
        dec = FrameDecoder()
        out = []
        for off in range(0, len(blob), chunk):
            out.extend(dec.feed(blob[off : off + chunk]))
        assert out == msgs

    check()


def test_hypothesis_decoder_never_hangs_or_crashes_on_garbage():
    """Arbitrary bytes fed to the decoder either wait for more input or
    raise ProtocolError — never any other exception, never a wrong decode
    of a frame that was not sent."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(junk=st.binary(max_size=512))
    @hyp.settings(max_examples=300, deadline=None)
    def check(junk):
        dec = FrameDecoder(max_frame=1 << 16)
        try:
            dec.feed(junk)
        except ProtocolError:
            pass

    check()


# ---------------------------------------------------------------------------
# codec: crafted adversarial inputs
# ---------------------------------------------------------------------------

def test_truncated_header_waits_not_raises():
    dec = FrameDecoder()
    assert dec.feed(b"\x01\x02\x03") == []  # 3 of 8 header bytes: torn, fine
    # completing the stream into a real frame still decodes
    frame = encode_wire("hello")
    dec2 = FrameDecoder()
    assert dec2.feed(frame[:5]) == []
    assert dec2.feed(frame[5:]) == ["hello"]


def test_crc_flip_raises_and_poisons():
    frame = bytearray(encode_wire({"k": 1}))
    frame[-1] ^= 0xFF  # flip a payload byte: CRC no longer matches
    dec = FrameDecoder()
    with pytest.raises(ProtocolError, match="CRC"):
        dec.feed(bytes(frame))
    # poisoned: even a pristine frame is refused now (resync inside a
    # corrupt pickle stream is hopeless)
    with pytest.raises(ProtocolError, match="poisoned"):
        dec.feed(encode_wire("fine"))


def test_oversized_length_fails_fast_without_allocating():
    hdr = _FRAME_HDR.pack(MAX_FRAME_LEN + 1, 0)
    dec = FrameDecoder()
    with pytest.raises(ProtocolError, match="exceeds cap"):
        dec.feed(hdr)


def test_undecodable_payload_raises_protocol_error():
    payload = b"\x80\x05not really a pickle"
    frame = _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload
    dec = FrameDecoder()
    with pytest.raises(ProtocolError, match="undecodable"):
        dec.feed(frame)


def test_crc_collision_resistance_on_length_corruption():
    """Corrupting the length field misaligns the stream; whatever bytes
    then land under the CRC check must not silently decode."""
    frame = bytearray(encode_wire(("req", 1, "kv.get", ("k",), {})))
    good_len = struct.unpack_from("<I", frame, 0)[0]
    struct.pack_into("<I", frame, 0, good_len - 1)
    dec = FrameDecoder()
    try:
        out = dec.feed(bytes(frame))
    except ProtocolError:
        return  # detected — the expected outcome
    assert out == []  # or: short frame now torn, waiting forever — also safe


def _buffer_frame_blob(msg):
    """Encode ``msg`` with its large bytes-likes extracted into buffer
    frames; returns (wire bytes, expected decoded message)."""
    buffers = []
    wire_msg = extract_buffers(msg, buffers)
    assert buffers, "payload should have been extracted into a buffer frame"
    return b"".join(bytes(p) for p in encode_wire_parts(wire_msg, buffers)), msg


def test_torn_buffer_frame_reassembles_across_every_chunking():
    """A buffer frame torn at arbitrary points — including mid-header and
    mid-payload — reassembles into the original message exactly; the raw
    payload bytes are counted on the buffer path, not the pickle path."""
    payload = bytes(range(256)) * (ZERO_COPY_MIN // 256 + 17)
    blob, msg = _buffer_frame_blob(("res", 9, payload))
    for step in (1, 7, 4096, ZERO_COPY_MIN + 3, len(blob)):
        dec = FrameDecoder()
        out = []
        for off in range(0, len(blob), step):
            out.extend(dec.feed(blob[off : off + step]))
        assert out == [msg], f"chunk size {step}"
        assert dec.bytes_buffer == len(payload)
        assert dec.bytes_pickled < 256  # only the tiny control frame


def test_torn_buffer_frame_fill_mode_recv_into_path():
    """The pump's fast path: a torn buffer frame flips the decoder into
    fill mode (``wanted``/``fill_view``/``filled``), and the socket bytes
    land directly in the payload's final buffer."""
    payload = bytes(range(251)) * (ZERO_COPY_MIN // 251 + 5)
    blob, msg = _buffer_frame_blob(("res", 3, payload))
    dec = FrameDecoder()
    pos = _FRAME_HDR.size + 10  # header + first 10 payload bytes
    assert dec.feed(blob[:pos]) == []
    assert dec.wanted() == len(payload) - 10
    while dec.wanted():
        n = min(dec.wanted(), 3333)  # a recv_into returning partial reads
        dec.fill_view()[:n] = blob[pos : pos + n]
        dec.filled(n)
        pos += n
    assert dec.wanted() == 0
    out = dec.feed(blob[pos:])  # the control frame binds the filled buffer
    assert out == [msg]
    assert dec.bytes_buffer == len(payload)


def test_buffer_frame_crc_flip_raises_and_poisons():
    payload = b"\xab" * (ZERO_COPY_MIN + 100)
    blob, _msg = _buffer_frame_blob(("res", 1, payload))
    corrupt = bytearray(blob)
    corrupt[_FRAME_HDR.size + 50] ^= 0xFF  # flip a raw payload byte
    dec = FrameDecoder()
    with pytest.raises(ProtocolError, match="CRC"):
        dec.feed(bytes(corrupt))
    with pytest.raises(ProtocolError, match="poisoned"):
        dec.feed(encode_wire("fine"))
    # same flip, but delivered through the fill-mode path
    dec2 = FrameDecoder()
    dec2.feed(bytes(corrupt[: _FRAME_HDR.size + 8]))
    n = len(payload) - 8
    dec2.fill_view()[:n] = corrupt[_FRAME_HDR.size + 8 : _FRAME_HDR.size + 8 + n]
    with pytest.raises(ProtocolError, match="CRC"):
        dec2.filled(n)


def test_dangling_buffer_placeholder_raises():
    """A control frame referencing a buffer index that never arrived is a
    protocol error, not a silent placeholder leak."""
    from repro_torch.storage.net_kv import _WireBuf

    small = b"x" * (ZERO_COPY_MIN + 1)
    buffers = []
    extract_buffers(small, buffers)  # one real buffer: index 0
    parts = encode_wire_parts(("res", 1, _WireBuf(1)), buffers)  # refers to #1
    dec = FrameDecoder()
    with pytest.raises(ProtocolError, match="without a matching buffer"):
        dec.feed(b"".join(bytes(p) for p in parts))


def test_small_payloads_stay_on_the_pickle_path():
    """Below ZERO_COPY_MIN nothing is extracted — one pickled frame, and
    small memoryviews are normalized to bytes so they still pickle."""
    buffers = []
    msg = extract_buffers(("res", 2, memoryview(b"small")), buffers)
    assert buffers == []
    assert msg == ("res", 2, b"small")
    dec = FrameDecoder()
    assert dec.feed(encode_wire(msg)) == [msg]
    assert dec.bytes_buffer == 0


def test_parse_addr_forms():
    assert parse_addr("127.0.0.1:4000") == ("127.0.0.1", 4000)
    assert parse_addr(("h", 9)) == ("h", 9)
    assert parse_addr("unix:/tmp/kvd.sock") == ("unix:/tmp/kvd.sock", 0)
    with pytest.raises(ValueError):
        parse_addr("no-port-here")


def test_parse_shard_map_forms():
    # single endpoint: the N=1 degenerate case
    assert parse_shard_map("127.0.0.1:4000") == [("127.0.0.1", 4000)]
    assert parse_shard_map(("h", 9)) == [("h", 9)]
    # comma-joined string and list forms; ORDER IS THE TOPOLOGY
    assert parse_shard_map("a:1, b:2") == [("a", 1), ("b", 2)]
    assert parse_shard_map(["a:1", ("b", 2), "unix:/tmp/k.sock"]) == [
        ("a", 1),
        ("b", 2),
        ("unix:/tmp/k.sock", 0),
    ]


# ---------------------------------------------------------------------------
# live server: malformed input is a per-connection error
# ---------------------------------------------------------------------------

@pytest.fixture
def server(tmp_path):
    srv = KVDServer(
        str(tmp_path / "kvd"),
        f"unix:{tmp_path / 'kvd.sock'}",
        num_shards=2,
        fsync="never",
    ).start()
    yield srv
    srv.close()


def _raw_conn(srv):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(5.0)
    sock.connect(srv.address[len("unix:"):])
    return sock


def _recv_closed(sock):
    """True if the peer closed the connection (EOF) within the timeout."""
    try:
        while True:
            if sock.recv(4096) == b"":
                return True
    except socket.timeout:
        return False
    finally:
        sock.close()


def test_garbage_closes_only_that_connection(server):
    good = NetKVStore(server.address)
    try:
        good.set("k", 1)
        evil = _raw_conn(server)
        evil.sendall(b"\xde\xad\xbe\xef" * 64)  # insane length + junk
        assert _recv_closed(evil), "server must drop the malformed conn"
        # the well-behaved client is completely unaffected
        assert good.get("k") == 1
        good.set("k2", 2)
        assert good.get("k2") == 2
    finally:
        good.close()


def test_corrupt_crc_closes_only_that_connection(server):
    good = NetKVStore(server.address)
    try:
        evil = _raw_conn(server)
        frame = bytearray(encode_wire(("sub", "evil", ("kv",))))
        frame[-1] ^= 0xFF
        evil.sendall(bytes(frame))
        assert _recv_closed(evil)
        good.set("x", "y")
        assert good.get("x") == "y"
    finally:
        good.close()


def test_half_sent_pipeline_applies_nothing(server):
    """A connection that dies mid-frame must leave no partial effects: ops
    execute only on whole, valid frames."""
    good = NetKVStore(server.address)
    try:
        evil = _raw_conn(server)
        # handshake properly so the conn is a real client
        evil.sendall(encode_wire(("sub", "evil-client", ())))
        dec = FrameDecoder()
        while not dec.feed(evil.recv(4096)):
            pass  # hello
        # one whole set + the first half of a second — then vanish
        whole = encode_wire(("req", 1, "kv.set", ("applied", 1), {}))
        torn = encode_wire(("req", 2, "kv.set", ("torn", 1), {}))
        evil.sendall(whole + torn[: len(torn) // 2])
        evil.close()
        deadline = time.monotonic() + 5.0
        while good.get("applied") is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert good.get("applied") == 1  # the whole frame landed
        assert good.get("torn") is None  # the torn one never executed
    finally:
        good.close()


def test_oversized_length_claim_rejected_without_allocation(server):
    evil = _raw_conn(server)
    evil.sendall(_FRAME_HDR.pack(MAX_FRAME_LEN + 1, 0))
    assert _recv_closed(evil)


def test_req_before_handshake_is_rejected(server):
    """The sub handshake gates everything; a request-first client is
    dropped cleanly."""
    evil = _raw_conn(server)
    evil.sendall(encode_wire(("req", 1, "kv.get", ("k",), {})))
    assert _recv_closed(evil)


def test_unpicklable_payload_closes_conn_not_server(server):
    good = NetKVStore(server.address)
    try:
        payload = b"\x80\x05garbage that is not a pickle"
        frame = _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload
        evil = _raw_conn(server)
        evil.sendall(frame)
        assert _recv_closed(evil)
        assert good.incr("alive") == 1
    finally:
        good.close()


# ---------------------------------------------------------------------------
# one wire, two packages: the port's codec against the JAX package's
# ---------------------------------------------------------------------------

import functools  # noqa: E402

from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core.functions import TaskSpec as JTaskSpec  # noqa: E402
from repro.storage import DELETE as JDELETE  # noqa: E402
from repro.storage import NetKVStore as JNetKVStore  # noqa: E402
from repro.storage import net_kv as jnet  # noqa: E402
from repro.storage.net_kv import RemoteError as JRemoteError  # noqa: E402
from repro_torch.core import scheduler  # noqa: E402
from repro_torch.core.functions import TaskSpec  # noqa: E402
from repro_torch.storage import DELETE  # noqa: E402
from repro_torch.storage import net_kv as tnet  # noqa: E402

_CHUNKS = (1, 7, 64, 4096, ZERO_COPY_MIN + 3)
_BIG = bytes(range(256)) * (ZERO_COPY_MIN // 256 + 3)


def _frames(codec, msg):
    """``msg`` as ``codec`` sends it: large payloads in buffer frames."""
    buffers = []
    wire = codec.extract_buffers(msg, buffers)
    return b"".join(bytes(p) for p in codec.encode_wire_parts(wire, buffers))


def _decode_chunked(codec, blob, step):
    dec = codec.FrameDecoder()
    out = []
    for off in range(0, len(blob), step):
        out.extend(dec.feed(blob[off : off + step]))
    return out


def test_plain_frames_are_byte_equal_to_jax():
    """A message of containers, strings, bytes and numbers — one that
    names no global — is the same bytes from either package, a large
    payload pickled in place included."""
    for msg in _SAMPLES + [("req", 4, "ob.put", ("blob", _BIG, False), {}),
                           ("res", 5, {"k": [_BIG, b"small", 1.5]})]:
        assert encode_wire(msg) == jnet.encode_wire(msg), msg[:2]


def test_buffer_frames_are_byte_equal_and_their_control_frames_decode_alike():
    """With zero-copy, the raw buffer frames are byte-equal; the control
    frame names the placeholder's class (by ``import_module`` + ``getattr``
    from the port, by a plain global from JAX), and each package's
    decoder gives the same message from either."""
    msg = ("res", 5, {"k": [_BIG, b"small", 1.5]})
    parts = {}
    for name, codec in (("port", tnet), ("jax", jnet)):
        buffers = []
        parts[name] = [bytes(p) for p in codec.encode_wire_parts(codec.extract_buffers(msg, buffers), buffers)]
    assert parts["port"][:-1] == parts["jax"][:-1] and len(parts["port"]) == 3
    for codec in (tnet, jnet):
        for name in parts:
            (got,) = codec.FrameDecoder().feed(b"".join(parts[name]))
            assert got == msg, (codec.__name__, name)


def _twins(port):
    """One message per kind of by-reference global the wire carries, as
    either package would send it: an eval partial, the DELETE sentinel,
    a TaskSpec, and a buffer frame's placeholder."""
    sch, spec, delete = (scheduler, TaskSpec, DELETE) if port else (jscheduler, JTaskSpec, JDELETE)
    return [
        ("req", 1, "kv.eval", ("lease/x", functools.partial(sch._fenced_decay, 2.0), None), {}),
        ("res", 2, delete),
        ("req", 3, "kv.rpush", ("q", spec("t", "j", "fk", "fn", "ik", "rk")), {}),
        ("res", 4, [_BIG, "tail"]),
    ]


def _same(got, exp_port):
    """``got`` decoded by the port (``exp_port``) or by JAX equals the
    receiving package's own form of ``_twins``."""
    (req1, res2, req3, res4) = got
    sch, spec, delete = (scheduler, TaskSpec, DELETE) if exp_port else (jscheduler, JTaskSpec, JDELETE)
    fn = req1[3][1]
    assert fn.func is sch._fenced_decay and fn.args == (2.0,)
    assert res2[2] is delete
    assert type(req3[3][1]) is spec and req3[3][1] == spec("t", "j", "fk", "fn", "ik", "rk")
    assert bytes(res4[2][0]) == _BIG and res4[2][1] == "tail"


@pytest.mark.parametrize("step", _CHUNKS)
def test_jax_frames_decode_with_the_port_under_any_chunking(step):
    blob = b"".join(_frames(jnet, m) for m in _SAMPLES + _twins(port=False))
    out = _decode_chunked(tnet, blob, step)
    assert out[: len(_SAMPLES)] == _SAMPLES
    _same(out[len(_SAMPLES):], exp_port=True)


@pytest.mark.parametrize("step", _CHUNKS)
def test_port_frames_decode_with_jax_under_any_chunking(step):
    blob = b"".join(_frames(tnet, m) for m in _SAMPLES + _twins(port=True))
    out = _decode_chunked(jnet, blob, step)
    assert out[: len(_SAMPLES)] == _SAMPLES
    _same(out[len(_SAMPLES):], exp_port=False)


def test_port_frames_name_the_jax_package_not_the_port():
    """The port writes its globals under ``repro.*`` and reads them back
    as its own: no ``repro_torch`` name crosses the wire."""
    for msg in _twins(port=True):
        frame = _frames(tnet, msg)
        assert b"repro_torch" not in frame and b"repro." in frame
    _same([FrameDecoder().feed(_frames(tnet, m))[0] for m in _twins(port=True)], exp_port=True)


def test_globals_without_a_twin_are_refused_by_name():
    """A frame naming what the port cannot resolve — a JAX client's
    cloudpickled closure, a JAX module the port has no twin of, jax
    itself — decodes whole as an ``UnresolvedMessage`` naming them, and
    the decoder stays usable."""
    import cloudpickle
    import jax.numpy as jnp

    closure = cloudpickle.dumps(("req", 1, "kv.eval", ("k", lambda cur: cur, None), {}))
    dec = FrameDecoder()
    (msg,) = dec.feed(_FRAME_HDR.pack(len(closure), zlib.crc32(closure)) + closure)
    assert isinstance(msg, tnet.UnresolvedMessage) and msg.msg[:3] == ("req", 1, "kv.eval")
    assert any(n.startswith("cloudpickle.") for n in msg.names)
    # no module of that name in the port: the Pallas mLSTM's twin is
    # repro_torch.kernels.mlstm
    from repro.kernels import mlstm_kernel as jmlstm

    for i, obj in enumerate((jmlstm.mlstm_pallas, jnp.float32)):
        (msg,) = dec.feed(jnet.encode_wire(("res", 10 + i, obj)))
        assert isinstance(msg, tnet.UnresolvedMessage), obj
        assert msg.names[0].startswith(("repro.kernels.mlstm_kernel", "jax"))
    assert dec.feed(jnet.encode_wire(("res", 3, "fine"))) == [("res", 3, "fine")]


def test_unpicklable_request_raises_type_error_at_the_caller(server):
    """A closure cannot be sent: ``TypeError`` naming the op and the
    value, raised before anything is sent; the connection lives on."""
    kv = NetKVStore(server.address)
    try:
        kv.set("n", 1)
        with pytest.raises(TypeError, match=r"kv\.eval_many: cannot send <function .*<lambda>"):
            kv.eval_many({"n": lambda cur: cur + 1, "m": functools.partial(scheduler._incr_counter)})
        assert kv.get("n") == 1 and not kv.exists("m")  # nothing was applied
        assert kv.incr("n") == 2
        assert kv._client.reconnects == 0
    finally:
        kv.close()


def test_jax_closure_gets_a_clean_error_from_the_ports_daemon(server):
    """A JAX client's cloudpickled eval reaches the port's daemon, which
    never imports cloudpickle: the call fails with the names, the
    connection and the key are untouched."""
    jkv = JNetKVStore(server.address)
    try:
        jkv.set("k", 5)
        with pytest.raises(JRemoteError, match="cloudpickle"):
            jkv.eval("k", lambda cur: cur * 2)
        assert jkv.get("k") == 5 and jkv.incr("k") == 6
        assert jkv._client.reconnects == 0
    finally:
        jkv.close()
