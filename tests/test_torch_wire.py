"""The port's wire frame codec (``repro_torch.core.wire``) under the
properties of ``tests/test_wire.py``, property for property, plus one
that the two packages put the same bytes on the wire for every generated
message and chunk body, so a client of either package talks to a server
of either.

Property-based tests (hypothesis) on the wire frame codec
(``core/wire.py``): every protocol message type round-trips through a
frame bit-exactly, chunk bodies survive for every supported dtype and
boundary size, and malformed / truncated / oversized / wrong-version
frames are rejected with the typed errors the server relies on for
per-connection fault containment.

Skipped cleanly when hypothesis is absent (it is declared in the
``test`` extra of pyproject.toml; CI installs it)."""
import socket
import struct

import msgpack
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed; pip install -e '.[test]' to run these")
from hypothesis import given, settings, strategies as st  # noqa: E402

import dataclasses  # noqa: E402

from repro.core import protocol as ref_protocol, wire as ref_wire  # noqa: E402
from repro.core.handles import MatrixHandle as RefMatrixHandle  # noqa: E402
from repro_torch.core import protocol, wire  # noqa: E402
from repro_torch.core.handles import MatrixHandle  # noqa: E402

# ---- strategies -------------------------------------------------------
_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2**40, 2**40),
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    st.text(max_size=12), st.binary(max_size=12))

_handles = st.builds(
    MatrixHandle,
    id=st.integers(1, 2**31),
    shape=st.tuples(st.integers(0, 999), st.integers(0, 99)),
    dtype=st.sampled_from(["float32", "float64", "int32"]),
    layout=st.sampled_from(["rowblock", "block2d", "replicated"]),
    name=st.one_of(st.none(), st.text(max_size=8)))

_deferred = st.builds(protocol.DeferredHandle,
                      task=st.integers(1, 2**31), key=st.text(max_size=8))

_args = st.dictionaries(
    st.text(min_size=1, max_size=8),
    st.one_of(_scalars, _handles, _deferred,
              st.lists(_scalars, max_size=3),
              st.dictionaries(st.text(min_size=1, max_size=4), _scalars,
                              max_size=3)),
    max_size=4)

_messages = st.one_of(
    st.builds(protocol.Handshake,
              action=st.sampled_from([protocol.CONNECT,
                                      protocol.DISCONNECT]),
              client=st.text(max_size=10), session=st.integers(0, 2**20)),
    st.builds(protocol.Command, library=st.text(min_size=1, max_size=10),
              routine=st.text(min_size=1, max_size=10), args=_args,
              session=st.integers(0, 2**20)),
    st.builds(protocol.TaskOp,
              action=st.sampled_from([protocol.POLL, protocol.WAIT]),
              task=st.integers(0, 2**31), session=st.integers(0, 2**20)),
    st.builds(protocol.Describe, library=st.text(max_size=10),
              session=st.integers(0, 2**20)),
    st.builds(protocol.Configure, session=st.integers(0, 2**20),
              options=st.dictionaries(
                  st.sampled_from(["backend", "fusion"]),
                  st.one_of(st.text(max_size=6), st.booleans()),
                  max_size=2)),
    st.builds(protocol.Result, values=_args,
              elapsed=st.floats(0, 1e3, allow_nan=False),
              error=st.text(max_size=20), session=st.integers(0, 2**20),
              task=st.integers(0, 2**31),
              state=st.sampled_from(["", "QUEUED", "DONE", "FAILED"]),
              wait_s=st.floats(0, 1e3, allow_nan=False),
              exec_s=st.floats(0, 1e3, allow_nan=False),
              cache_hit=st.booleans(),
              saved_s=st.floats(0, 1e3, allow_nan=False)))


# ---- typed message round trips ----------------------------------------
@settings(max_examples=120, deadline=None)
@given(msg=_messages)
def test_every_message_type_roundtrips_through_a_frame(msg):
    frame = wire.encode_message(msg)
    ftype, payload = wire.decode_frame(frame)
    assert wire.decode_message(ftype, payload) == msg


@settings(max_examples=60, deadline=None)
@given(msg=_messages)
def test_frames_survive_arbitrary_stream_slicing(msg):
    """A frame parsed off a buffered stream equals the buffer parse —
    framing is self-delimiting regardless of how TCP segments it."""
    import io

    frame = wire.encode_message(msg)
    got = wire.read_frame(io.BufferedReader(io.BytesIO(frame),
                                            buffer_size=1))
    assert got is not None
    assert wire.decode_message(*got) == msg


# ---- chunk bodies: dtype and boundary-size coverage -------------------
@settings(max_examples=80, deadline=None)
@given(
    dtype=st.sampled_from(["float32", "float64", "int32", "int64",
                           "uint8", "bool", "complex64"]),
    rows=st.integers(0, 33), cols=st.integers(0, 9),
    seed=st.integers(0, 2**31))
def test_chunk_bodies_roundtrip_every_dtype_and_size(dtype, rows, cols,
                                                     seed):
    rng = np.random.RandomState(seed % 2**32)
    a = (rng.randn(rows, cols) * 100).astype(dtype)
    frame = wire.encode_frame(
        wire.FRAME_UPLOAD_CHUNK,
        msgpack.packb({"array": wire.pack_ndarray(a)}))
    ftype, payload = wire.decode_frame(frame)
    back = wire.unpack_ndarray(msgpack.unpackb(payload)["array"])
    assert back.dtype == a.dtype and back.shape == a.shape
    np.testing.assert_array_equal(back, a)


@settings(max_examples=30, deadline=None)
@given(size=st.sampled_from([0, 1, 2, 11, 4096, 65536]))
def test_boundary_payload_sizes_roundtrip(size):
    payload = bytes(size)
    frame = wire.encode_frame(wire.FRAME_RESULT, payload)
    assert len(frame) == wire.HEADER_BYTES + size
    assert wire.decode_frame(frame) == (wire.FRAME_RESULT, payload)


def test_object_dtype_is_refused():
    a = np.array([object()], dtype=object)
    with pytest.raises((wire.WireError, TypeError)):
        wire.pack_ndarray(a)
    with pytest.raises(wire.WireError):
        wire.unpack_ndarray({"shape": [1], "dtype": "object",
                             "data": b"x"})


# ---- the two packages' bytes ----------------------------------------
def _to_ref(v):
    """A port message, handle or value as the JAX package's own."""
    if isinstance(v, MatrixHandle):
        return RefMatrixHandle(**{f.name: getattr(v, f.name)
                                  for f in dataclasses.fields(v)})
    if isinstance(v, protocol.DeferredHandle):
        return ref_protocol.DeferredHandle(task=v.task, key=v.key)
    if isinstance(v, dict):
        return {k: _to_ref(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_ref(x) for x in v]
    if dataclasses.is_dataclass(v):
        cls = getattr(ref_protocol, type(v).__name__)
        return cls(**{f.name: _to_ref(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
    return v


@settings(max_examples=80, deadline=None)
@given(msg=_messages,
       dtype=st.sampled_from(["float32", "float64", "int32", "int64",
                              "uint8", "bool", "complex64", "bfloat16"]),
       rows=st.integers(0, 17), cols=st.integers(0, 5),
       seed=st.integers(0, 2**31))
def test_both_packages_put_the_same_bytes_on_the_wire(msg, dtype, rows,
                                                      cols, seed):
    assert wire.encode_message(msg) == \
        ref_wire.encode_message(_to_ref(msg))
    import ml_dtypes
    rng = np.random.RandomState(seed % 2**32)
    a = (rng.randn(rows, cols) * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    body = {"lo": 0, "hi": rows, "array": wire.pack_ndarray(a)}
    assert body["array"] == ref_wire.pack_ndarray(a)
    assert wire.encode_frame(wire.FRAME_FETCH_CHUNK, msgpack.packb(body)) \
        == ref_wire.encode_frame(ref_wire.FRAME_FETCH_CHUNK,
                                 msgpack.packb(body))


# ---- malformed frames are rejected with typed errors ------------------
@settings(max_examples=60, deadline=None)
@given(msg=_messages, data=st.data())
def test_truncated_frames_raise_typed(msg, data):
    """Cutting a frame anywhere — mid-header or mid-payload — is a
    TruncatedFrame, never a silent short read or a wrong parse."""
    frame = wire.encode_message(msg)
    cut = data.draw(st.integers(1, len(frame)))
    with pytest.raises(wire.TruncatedFrame):
        wire.decode_frame(frame[:len(frame) - cut])


def test_bad_magic_raises_typed():
    frame = b"NOPE" + wire.encode_frame(wire.FRAME_RESULT, b"")[4:]
    with pytest.raises(wire.BadMagic):
        wire.decode_frame(frame)


def test_oversized_frames_refused_both_directions(monkeypatch):
    # decode side: a hostile/corrupt declared length is refused from the
    # header alone, before any payload allocation
    header = struct.pack(">4sBBHI", wire.MAGIC, wire.WIRE_VERSION,
                         wire.FRAME_RESULT, 0, wire.MAX_FRAME_BYTES + 1)
    with pytest.raises(wire.FrameTooLarge):
        wire.decode_header(header)
    # encode side: refuse to emit what no peer would accept (cap shrunk
    # so the test doesn't allocate 256 MiB)
    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 1024)
    with pytest.raises(wire.FrameTooLarge):
        wire.encode_frame(wire.FRAME_RESULT, bytes(2048))


@settings(max_examples=40, deadline=None)
@given(ftype=st.integers(0, 255).filter(
    lambda t: t not in wire.FRAME_TYPES))
def test_unknown_frame_types_raise_typed(ftype):
    header = struct.pack(">4sBBHI", wire.MAGIC, wire.WIRE_VERSION,
                         ftype, 0, 0)
    with pytest.raises(wire.UnknownFrameType):
        wire.decode_header(header)
    with pytest.raises(wire.UnknownFrameType):
        wire.encode_frame(ftype, b"")


@settings(max_examples=40, deadline=None)
@given(version=st.integers(0, 255).filter(
    lambda v: v != wire.WIRE_VERSION))
def test_version_mismatch_raises_typed(version):
    header = struct.pack(">4sBBHI", wire.MAGIC, version,
                         wire.FRAME_HANDSHAKE, 0, 0)
    with pytest.raises(wire.VersionMismatch):
        wire.decode_header(header)


def test_error_frames_rebuild_their_typed_fault():
    for exc in (wire.BadMagic("m"), wire.VersionMismatch("v"),
                wire.FrameTooLarge("l"), wire.UnknownFrameType("t"),
                wire.TruncatedFrame("c"), wire.RemoteFault("f")):
        back = wire.decode_error(wire.encode_error(exc))
        assert type(back) is type(exc)
        assert str(exc) in str(back)


# ---- version-mismatch handshake refusal, live against a server --------
def test_version_mismatch_handshake_is_refused_by_server():
    """A client speaking a different wire version is told so in a typed
    ERROR frame and hung up on — before any engine state is touched."""
    from repro_torch.core.server import AlchemistServer

    with AlchemistServer(device="cpu") as srv:
        sessions_before = len(srv.engine.sessions())
        sock = socket.create_connection((srv.host, srv.port), timeout=30)
        try:
            hs = protocol.encode_handshake(
                protocol.Handshake(action=protocol.CONNECT, client="v2"))
            sock.sendall(wire.encode_frame(wire.FRAME_HANDSHAKE, hs,
                                           version=wire.WIRE_VERSION + 1))
            rfile = sock.makefile("rb")
            got = wire.read_frame(rfile)
            assert got is not None
            ftype, payload = got
            assert ftype == wire.FRAME_ERROR
            with pytest.raises(wire.VersionMismatch):
                raise wire.decode_error(payload)
            assert rfile.read(1) == b""        # server hung up
        finally:
            sock.close()
        assert len(srv.engine.sessions()) == sessions_before