"""The wire layer: versioned length-prefixed frames + the TCP client
bridge (the transport the paper actually runs on, §3.1.2/§3.2).

Every message between an :class:`AlchemistContext` and a remote engine
crosses as one binary *frame*:

    0      4      5      6        8          12
    +------+------+------+--------+----------+------------------+
    | ALCH | ver  | type | flags  | length   | payload ...      |
    +------+------+------+--------+----------+------------------+
      4 B    u8     u8     u16      u32 BE     `length` bytes

``ALCH`` is the magic, ``ver`` the wire-protocol version (a peer speaking
a different version is refused at the first frame — no silent
misinterpretation of bytes), ``type`` selects the payload codec below,
``flags`` is reserved (must be zero), and ``length`` bounds the payload
(frames over :data:`MAX_FRAME_BYTES` are refused before any allocation).

Payloads are the *existing* msgpack codecs from ``core/protocol.py`` —
one frame type per protocol dataclass (Handshake, Command, TaskOp,
Describe, Configure, Result), so the socket bridge and the in-memory
bridge serialize identically and ``DeferredHandle``/``MatrixHandle``
arguments cross through the same tagged encoding. Matrix *data* crosses
as raw-bytes chunk frames (:func:`pack_ndarray`: shape + dtype string +
C-order buffer — never pickle, so a hostile peer can at worst hand back
wrong numbers, not run code).

Framing faults are typed: :class:`BadMagic`, :class:`VersionMismatch`,
:class:`FrameTooLarge`, :class:`UnknownFrameType`, :class:`TruncatedFrame`
— all :class:`WireError`, all fatal to the one connection that produced
them and invisible to every other tenant of the server.

:class:`SocketBridge` is the client half: it exposes exactly the
endpoint surface of :class:`~repro_torch.core.engine.AlchemistEngine` that
``AlchemistContext`` and ``core/transfer.py`` consume (``handshake`` /
``submit`` / ``task_op`` / ``describe`` / ``configure`` / ``free`` plus
the chunked upload/fetch verbs), so a context constructed with
``address="host:port"`` behaves identically to one holding an in-process
engine — same façade, same lazy AlMatrix chaining, same error types.
"""
from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Any, Callable, Optional

import msgpack
import numpy as np

from repro_torch.analysis import locktrace
from repro_torch.core import protocol
from repro_torch.core.costmodel import TransferRecord, WireLog

MAGIC = b"ALCH"
WIRE_VERSION = 1

# magic, version, frame type, flags (reserved, 0), payload length
_HEADER = struct.Struct(">4sBBHI")
HEADER_BYTES = _HEADER.size

# Hard per-frame cap: transfers chunk at ~4 MiB, control messages are
# tiny, so anything near this is a corrupt or hostile length field — the
# cap is checked before any payload allocation.
MAX_FRAME_BYTES = 256 << 20

# ---- frame registry ---------------------------------------------------
# The single source of truth for the frame table. FRAME_TYPES, the
# server dispatch dict (server._Connection._ENDPOINTS) and the client's
# expected-reply sets are all *generated* from this tuple — adding a
# frame means adding one FrameSpec row (and its handler, which the
# repro.analysis WIRE rules then demand exists), never editing three
# hand-maintained literals.
@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """One row of the wire-protocol frame table.

    ``name`` yields the module constant ``FRAME_<name>``; ``role`` is
    ``request`` (client -> server, dispatched to ``endpoint``),
    ``reply`` (server -> client) or ``error`` (either direction);
    ``replies`` names the frames a well-behaved server may answer a
    request with (empty for pipelined frames that are never acked).
    """
    name: str
    code: int
    role: str
    endpoint: str = ""
    replies: tuple = ()


FRAME_SPECS: tuple[FrameSpec, ...] = (
    # control plane (payload = the matching protocol.py codec)
    FrameSpec("HANDSHAKE", 0x01, "request", "handshake", ("RESULT",)),
    FrameSpec("COMMAND", 0x02, "request", "submit",
              ("RESULT", "THROTTLE")),
    FrameSpec("TASK_OP", 0x03, "request", "task_op", ("RESULT",)),
    FrameSpec("DESCRIBE", 0x04, "request", "describe", ("RESULT",)),
    FrameSpec("CONFIGURE", 0x05, "request", "configure", ("RESULT",)),
    FrameSpec("FREE", 0x06, "request", "free", ("RESULT",)),
    FrameSpec("RESULT", 0x10, "reply"),
    # THROTTLE carries the same Result payload as RESULT but names the
    # admission-control outcome in the frame type itself: the engine is
    # refusing (over-quota tenant), not failing — clients back off for
    # ``retry_after_s`` instead of treating it as an error (core/qos)
    FrameSpec("THROTTLE", 0x11, "reply"),
    FrameSpec("ERROR", 0x7F, "error"),
    # data plane (chunked transfers, §3.2)
    FrameSpec("ALIAS_LOOKUP", 0x20, "request", "alias_lookup",
              ("RESULT",)),
    FrameSpec("UPLOAD_BEGIN", 0x21, "request", "upload",
              ("RESULT", "THROTTLE")),
    # pipelined: no per-chunk ack
    FrameSpec("UPLOAD_CHUNK", 0x22, "request", "upload"),
    FrameSpec("UPLOAD_COMMIT", 0x23, "request", "upload", ("RESULT",)),
    FrameSpec("FETCH", 0x30, "request", "fetch",
              ("RESULT", "FETCH_META", "FETCH_CHUNK", "FETCH_END")),
    FrameSpec("FETCH_META", 0x31, "reply"),
    FrameSpec("FETCH_CHUNK", 0x32, "reply"),
    # FETCH_END carries the aggregate TransferRecord
    FrameSpec("FETCH_END", 0x33, "reply"),
)

FRAMES_BY_NAME: dict[str, FrameSpec] = {s.name: s for s in FRAME_SPECS}
FRAMES_BY_CODE: dict[int, FrameSpec] = {s.code: s for s in FRAME_SPECS}

# readable aliases (values live only in FRAME_SPECS)
FRAME_HANDSHAKE = FRAMES_BY_NAME["HANDSHAKE"].code
FRAME_COMMAND = FRAMES_BY_NAME["COMMAND"].code
FRAME_TASK_OP = FRAMES_BY_NAME["TASK_OP"].code
FRAME_DESCRIBE = FRAMES_BY_NAME["DESCRIBE"].code
FRAME_CONFIGURE = FRAMES_BY_NAME["CONFIGURE"].code
FRAME_FREE = FRAMES_BY_NAME["FREE"].code
FRAME_RESULT = FRAMES_BY_NAME["RESULT"].code
FRAME_THROTTLE = FRAMES_BY_NAME["THROTTLE"].code
FRAME_ERROR = FRAMES_BY_NAME["ERROR"].code
FRAME_ALIAS_LOOKUP = FRAMES_BY_NAME["ALIAS_LOOKUP"].code
FRAME_UPLOAD_BEGIN = FRAMES_BY_NAME["UPLOAD_BEGIN"].code
FRAME_UPLOAD_CHUNK = FRAMES_BY_NAME["UPLOAD_CHUNK"].code
FRAME_UPLOAD_COMMIT = FRAMES_BY_NAME["UPLOAD_COMMIT"].code
FRAME_FETCH = FRAMES_BY_NAME["FETCH"].code
FRAME_FETCH_META = FRAMES_BY_NAME["FETCH_META"].code
FRAME_FETCH_CHUNK = FRAMES_BY_NAME["FETCH_CHUNK"].code
FRAME_FETCH_END = FRAMES_BY_NAME["FETCH_END"].code

FRAME_TYPES = frozenset(FRAMES_BY_CODE)

#: frame code -> server dispatch endpoint, for every request frame —
#: what server._Connection binds as its dispatch table
REQUEST_ENDPOINTS: dict[int, str] = {
    s.code: s.endpoint for s in FRAME_SPECS if s.role == "request"}

#: request frame code -> frame codes a client may accept in reply
EXPECTED_REPLIES: dict[int, frozenset] = {
    s.code: frozenset(FRAMES_BY_NAME[r].code for r in s.replies)
    for s in FRAME_SPECS if s.role == "request"}


# ---- typed framing faults ---------------------------------------------
class WireError(ConnectionError):
    """Any transport-layer fault. Subclasses name the specific framing
    violation; all of them are fatal to the connection they occurred on
    (framing state cannot be resynchronized) and only to it."""


class BadMagic(WireError):
    """The 4 leading bytes were not ``ALCH`` — not our protocol."""


class VersionMismatch(WireError):
    """Peer speaks a different wire version; refused at the first frame."""


class FrameTooLarge(WireError):
    """Declared payload length exceeds :data:`MAX_FRAME_BYTES`."""


class UnknownFrameType(WireError):
    """Well-formed header naming a frame type this version doesn't know."""


class TruncatedFrame(WireError):
    """The stream ended mid-header or mid-payload."""


class RemoteFault(WireError):
    """The peer reported a transport-level fault (an ``ERROR`` frame)."""


# what an ERROR frame's ``kind`` maps back to on the receiving side, so a
# server-detected framing fault re-raises as the same typed error the
# client would have raised had it detected the fault itself
_ERROR_KINDS: dict[str, type] = {
    "bad_magic": BadMagic,
    "version": VersionMismatch,
    "too_large": FrameTooLarge,
    "unknown_type": UnknownFrameType,
    "truncated": TruncatedFrame,
}


def error_kind(exc: WireError) -> str:
    """The ``kind`` tag an ERROR frame uses for ``exc`` (inverse of
    :data:`_ERROR_KINDS`; plain faults tag as ``"fault"``)."""
    for kind, cls in _ERROR_KINDS.items():
        if type(exc) is cls:
            return kind
    return "fault"


# ---- frame codec ------------------------------------------------------
def encode_frame(frame_type: int, payload: bytes,
                 version: int = WIRE_VERSION) -> bytes:
    """One complete frame: header + payload."""
    if frame_type not in FRAME_TYPES:
        raise UnknownFrameType(f"unknown frame type 0x{frame_type:02x}")
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameTooLarge(
            f"payload of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte frame cap")
    return _HEADER.pack(MAGIC, version, frame_type, 0,
                        len(payload)) + payload


def decode_header(header: bytes) -> tuple[int, int]:
    """Validate a 12-byte header; returns ``(frame_type, payload_len)``.

    Check order matters: magic first (is this even our protocol?), then
    version (can we interpret anything that follows?), then the length
    cap (refuse before allocating), then the type — so a version-2 peer
    is told about the version, not about a frame type v1 happens not to
    know."""
    if len(header) < HEADER_BYTES:
        raise TruncatedFrame(
            f"frame header truncated at {len(header)}/{HEADER_BYTES} bytes")
    magic, version, frame_type, flags, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise BadMagic(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if version != WIRE_VERSION:
        raise VersionMismatch(
            f"peer speaks wire version {version}, this end speaks "
            f"{WIRE_VERSION}")
    if length > MAX_FRAME_BYTES:
        raise FrameTooLarge(
            f"declared payload of {length} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte frame cap")
    if frame_type not in FRAME_TYPES:
        raise UnknownFrameType(f"unknown frame type 0x{frame_type:02x}")
    return frame_type, length


def decode_frame(data: bytes) -> tuple[int, bytes]:
    """Parse one complete frame from ``data`` (which must hold exactly
    one frame — the buffer-level inverse of :func:`encode_frame`)."""
    frame_type, length = decode_header(data[:HEADER_BYTES])
    payload = data[HEADER_BYTES:]
    if len(payload) < length:
        raise TruncatedFrame(
            f"frame payload truncated at {len(payload)}/{length} bytes")
    return frame_type, payload[:length]


def read_frame(rfile) -> Optional[tuple[int, bytes]]:
    """Read one frame from a (buffered, blocking) byte stream.

    Returns ``None`` on clean EOF at a frame boundary — the peer hung up
    between messages, which is how connections end — and raises
    :class:`TruncatedFrame` on EOF anywhere inside a frame."""
    header = rfile.read(HEADER_BYTES)
    if not header:
        return None
    frame_type, length = decode_header(header)
    payload = rfile.read(length) if length else b""
    if len(payload) < length:
        raise TruncatedFrame(
            f"stream ended {length - len(payload)} bytes short of the "
            "declared payload")
    return frame_type, payload


# ---- typed message <-> frame mapping ----------------------------------
_MESSAGE_CODECS: dict[type, tuple[int, Callable, Callable]] = {
    protocol.Handshake: (FRAME_HANDSHAKE, protocol.encode_handshake,
                         protocol.decode_handshake),
    protocol.Command: (FRAME_COMMAND, protocol.encode_command,
                       protocol.decode_command),
    protocol.TaskOp: (FRAME_TASK_OP, protocol.encode_task_op,
                      protocol.decode_task_op),
    protocol.Describe: (FRAME_DESCRIBE, protocol.encode_describe,
                        protocol.decode_describe),
    protocol.Configure: (FRAME_CONFIGURE, protocol.encode_configure,
                         protocol.decode_configure),
    protocol.Result: (FRAME_RESULT, protocol.encode_result,
                      protocol.decode_result),
}
_FRAME_DECODERS = {ftype: dec
                   for ftype, _, dec in _MESSAGE_CODECS.values()}
# THROTTLE shares RESULT's payload codec — only the frame type differs
_FRAME_DECODERS[FRAME_THROTTLE] = protocol.decode_result


def encode_message(msg) -> bytes:
    """Frame any ``protocol.py`` dataclass with its canonical codec."""
    codec = _MESSAGE_CODECS.get(type(msg))
    if codec is None:
        raise TypeError(
            f"{type(msg).__name__} is not a wire message "
            f"(one of {sorted(c.__name__ for c in _MESSAGE_CODECS)})")
    ftype, enc, _ = codec
    return encode_frame(ftype, enc(msg))


def decode_message(frame_type: int, payload: bytes):
    """Inverse of :func:`encode_message` for the typed control frames."""
    dec = _FRAME_DECODERS.get(frame_type)
    if dec is None:
        raise UnknownFrameType(
            f"frame type 0x{frame_type:02x} does not carry a protocol "
            "message")
    return dec(payload)


def encode_error(exc_or_msg, kind: str = "fault") -> bytes:
    """An ERROR frame payload. Pass a :class:`WireError` to preserve its
    type across the socket, or a plain string with an explicit kind."""
    if isinstance(exc_or_msg, WireError):
        kind = error_kind(exc_or_msg)
        exc_or_msg = str(exc_or_msg)
    return msgpack.packb({"kind": kind, "error": str(exc_or_msg)})


def decode_error(payload: bytes) -> WireError:
    """Rebuild the typed fault an ERROR frame carries (default
    :class:`RemoteFault` for kinds this version doesn't know)."""
    d = msgpack.unpackb(payload)
    cls = _ERROR_KINDS.get(d.get("kind", "fault"), RemoteFault)
    return cls(d.get("error", "remote fault"))


# ---- raw chunk bodies (no pickle of user data) ------------------------
def pack_ndarray(a: np.ndarray) -> dict:
    """Wire form of one array chunk: shape + dtype string + raw C-order
    bytes. msgpack carries the buffer as a bin field — nothing here is
    executable on decode."""
    a = np.ascontiguousarray(a)
    if a.dtype.hasobject:
        # tobytes() on an object array serializes *pointers* — never
        # meaningful on another host, and pickle is banned here
        raise WireError(
            f"dtype {a.dtype} cannot cross the wire as raw bytes")
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data": a.tobytes()}


def unpack_ndarray(d: dict) -> np.ndarray:
    """Inverse of :func:`pack_ndarray`; rejects malformed bodies as
    :class:`WireError` rather than leaking numpy internals."""
    try:
        dtype = np.dtype(d["dtype"])
        if dtype.hasobject:
            raise TypeError("object dtypes may not cross the wire")
        arr = np.frombuffer(d["data"], dtype=dtype)
        return arr.reshape([int(s) for s in d["shape"]])
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed array chunk: {e}") from e


def parse_address(address: str) -> tuple[str, int]:
    """``"host:port"`` (or bare ``":port"`` for localhost) -> tuple."""
    host, sep, port = str(address).rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"engine address must look like 'host:port', got {address!r}")
    return host or "127.0.0.1", int(port)


def _rebuild_engine_error(error: str) -> Exception:
    """Turn a Result's ``"ExcType: message"`` error string back into the
    exception the in-memory bridge would have raised, for the endpoints
    (``free``, fetch) where the engine raises instead of replying — so
    ``pytest.raises(KeyError, match=...)`` behaves identically on both
    bridges. Unknown types come back as :class:`RemoteFault`."""
    name, _, msg = error.partition(": ")
    if name == "AlchemistBusyError":
        from repro_torch.core.expr import AlchemistBusyError
        return AlchemistBusyError(msg or error)
    cls = {"KeyError": KeyError, "ValueError": ValueError,
           "TypeError": TypeError, "RuntimeError": RuntimeError,
           "TimeoutError": TimeoutError}.get(name)
    return cls(msg) if cls is not None else RemoteFault(error)


def raise_engine_error(res: protocol.Result) -> None:
    """Raise the typed exception a Result's ``error`` string names (no-op
    on success). Admission denials rebuild as ``AlchemistBusyError``
    carrying the Result's ``retry_after_s`` hint, so upload callers can
    back off exactly like the submit path does."""
    if not res.error:
        return
    name, _, msg = res.error.partition(": ")
    if name == "AlchemistBusyError":
        from repro_torch.core.expr import AlchemistBusyError
        raise AlchemistBusyError(msg or res.error,
                                 retry_after_s=res.retry_after_s)
    raise _rebuild_engine_error(res.error)


class SocketBridge:
    """The client half of the TCP bridge: one connection, one session's
    traffic (connection-per-session, like the paper's per-driver socket).

    Duck-types the engine-endpoint surface ``AlchemistContext`` and the
    transfer layer consume, taking and returning the *same* protocol
    bytes — the context cannot tell (and must not care) which bridge it
    holds. All request/reply exchanges serialize on an internal lock:
    the protocol is strictly request-response per connection, matching
    the engine's one-session-one-driver model.

    ``wire_log`` accounts every frame this client puts on / takes off
    the socket, per endpoint — the client-side mirror of the server's
    measured traffic, available even when the engine is a remote box.
    """

    def __init__(self, address: str, timeout: Optional[float] = None,
                 connect_timeout: float = 10.0):
        host, port = parse_address(address)
        self.address = f"{host}:{port}"
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        # request/reply reads block indefinitely by default (a wait on a
        # long-running routine is not a fault); callers opt into timeouts
        self._sock.settimeout(timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        # held across each request-response exchange (the protocol is
        # strictly serial per connection) — a long hold by design, and
        # visible as such in the REPRO_LOCK_TRACE report
        self._lock = locktrace.make_rlock("wire.bridge")
        self._closed = False
        self.wire_log = WireLog()

    # ---- plumbing -----------------------------------------------------
    def _send(self, endpoint: str, frame_type: int, payload: bytes) -> int:
        frame = encode_frame(frame_type, payload)
        self._sock.sendall(frame)
        self.wire_log.record(endpoint, frames_out=1, bytes_out=len(frame))
        return len(frame)

    def _recv(self, endpoint: str) -> tuple[int, bytes]:
        got = read_frame(self._rfile)
        if got is None:
            raise WireError(
                f"engine at {self.address} closed the connection")
        ftype, payload = got
        self.wire_log.record(endpoint, frames_in=1,
                             bytes_in=HEADER_BYTES + len(payload))
        if ftype == FRAME_ERROR:
            raise decode_error(payload)
        return ftype, payload

    def _rpc(self, endpoint: str, frame_type: int, payload: bytes) -> bytes:
        """One request-response exchange; returns the RESULT payload
        (protocol.Result bytes, exactly what the in-memory endpoint
        returns)."""
        with self._lock:
            self._check_open()
            self._send(endpoint, frame_type, payload)
            ftype, reply = self._recv(endpoint)
        if ftype not in EXPECTED_REPLIES[frame_type]:
            raise WireError(
                f"expected a RESULT frame from {endpoint}, got "
                f"0x{ftype:02x}")
        return reply

    def _check_open(self):
        if self._closed:
            raise WireError(
                f"connection to {self.address} is closed")

    # ---- the engine endpoint surface ----------------------------------
    def handshake(self, wire: bytes) -> bytes:
        return self._rpc("handshake", FRAME_HANDSHAKE, wire)

    def submit(self, wire: bytes) -> bytes:
        return self._rpc("submit", FRAME_COMMAND, wire)

    def task_op(self, wire: bytes) -> bytes:
        return self._rpc("task_op", FRAME_TASK_OP, wire)

    def describe(self, wire: bytes) -> bytes:
        return self._rpc("describe", FRAME_DESCRIBE, wire)

    def configure(self, wire: bytes) -> bytes:
        return self._rpc("configure", FRAME_CONFIGURE, wire)

    def free(self, handle, session: Optional[int] = None) -> None:
        payload = msgpack.packb({
            "handle": protocol._pack_value(handle), "session": session})
        res = protocol.decode_result(self._rpc("free", FRAME_FREE, payload))
        if res.error:
            raise _rebuild_engine_error(res.error)

    # ---- chunked transfers (the data plane, §3.2) ---------------------
    def alias_lookup(self, fingerprint: str, shape, session: int,
                     name: Optional[str], logical_nbytes: int,
                     num_chunks: int
                     ) -> Optional[tuple[Any, TransferRecord]]:
        """Pre-stream dedup probe: one tiny frame instead of the payload.
        Returns ``(alias handle, dedup record)`` on a content hit, else
        ``None`` (stream the bytes)."""
        payload = msgpack.packb({
            "fingerprint": fingerprint, "shape": [int(s) for s in shape],
            "session": session, "name": name,
            "logical_nbytes": int(logical_nbytes),
            "num_chunks": int(num_chunks)})
        res = protocol.decode_result(
            self._rpc("alias_lookup", FRAME_ALIAS_LOOKUP, payload))
        if res.error:
            raise _rebuild_engine_error(res.error)
        if not res.values.get("hit"):
            return None
        return res.values["handle"], TransferRecord(**res.values["record"])

    def upload(self, shape, dtype, chunks, *, session: int,
               name: Optional[str] = None, num_chunks: int = 1,
               fingerprint=None, single: bool = False
               ) -> tuple[Any, TransferRecord]:
        """Stream one matrix: BEGIN, then pipelined CHUNK frames (no
        per-chunk ack — the paper's buffered sends), then COMMIT, whose
        reply carries the minted handle and the server's aggregate
        TransferRecord with honest bytes-on-the-wire.

        ``fingerprint`` may be a string, ``None``, or a zero-arg callable
        resolved *after* the chunks are consumed (inline hashing of
        single-pass sources). ``single=True`` marks a whole-matrix
        single-shot send (empty/scalar matrices and already-device-
        resident arrays) which the server logs as one plain record, like
        the in-memory single-shot path."""
        begin = msgpack.packb({
            "shape": [int(s) for s in shape], "dtype": str(dtype),
            "session": session, "name": name,
            "num_chunks": int(num_chunks), "single": bool(single)})
        with self._lock:
            self._check_open()
            self._send("upload", FRAME_UPLOAD_BEGIN, begin)
            ftype, reply = self._recv("upload")
            res = protocol.decode_result(reply)
            raise_engine_error(res)
            upload_id = res.values["upload"]
            for seq, chunk in enumerate(chunks):
                self._send("upload", FRAME_UPLOAD_CHUNK, msgpack.packb({
                    "upload": upload_id, "seq": seq,
                    "array": pack_ndarray(chunk)}))
            fp = fingerprint() if callable(fingerprint) else fingerprint
            self._send("upload", FRAME_UPLOAD_COMMIT, msgpack.packb({
                "upload": upload_id, "fingerprint": fp}))
            ftype, reply = self._recv("upload")
        res = protocol.decode_result(reply)
        raise_engine_error(res)
        return (res.values["handle"],
                TransferRecord(**res.values["record"]))

    def fetch(self, handle, *, session: int, chunk_rows: Optional[int],
              num_partitions: int, on_meta, on_chunk) -> TransferRecord:
        """Stream one matrix back: a single FETCH request answered by
        META, then CHUNK frames, then END with the aggregate record.
        ``on_meta(meta)`` sees shape/dtype/partition plan before any
        data; ``on_chunk(lo, hi, array)`` lands each row block — peak
        client memory stays one chunk."""
        payload = msgpack.packb({
            "handle": protocol._pack_value(handle), "session": session,
            "chunk_rows": chunk_rows, "num_partitions": int(num_partitions)})
        with self._lock:
            self._check_open()
            self._send("fetch", FRAME_FETCH, payload)
            ftype, reply = self._recv("fetch")
            if ftype == FRAME_RESULT:
                res = protocol.decode_result(reply)
                raise _rebuild_engine_error(res.error or
                                            "fetch failed without detail")
            if ftype != FRAME_FETCH_META:
                raise WireError(
                    f"expected FETCH_META, got frame 0x{ftype:02x}")
            on_meta(msgpack.unpackb(reply))
            while True:
                ftype, reply = self._recv("fetch")
                if ftype not in EXPECTED_REPLIES[FRAME_FETCH]:
                    raise WireError(
                        f"unexpected frame 0x{ftype:02x} inside a fetch "
                        "stream")
                if ftype == FRAME_FETCH_CHUNK:
                    d = msgpack.unpackb(reply)
                    on_chunk(d["lo"], d["hi"], unpack_ndarray(d["array"]))
                elif ftype == FRAME_FETCH_END:
                    d = msgpack.unpackb(reply)
                    return TransferRecord(**d["record"])
                else:
                    raise WireError(
                        f"mis-sequenced frame 0x{ftype:02x} inside a "
                        "fetch stream")

    # ---- lifecycle ----------------------------------------------------
    def close(self) -> None:
        """Hang up. Idempotent; the server reclaims this connection's
        sessions if the client never sent its disconnect handshake."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._rfile.close()
            self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed
