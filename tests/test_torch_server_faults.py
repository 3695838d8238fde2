"""The port's TCP engine server (``repro_torch.core.server``) under the
fault harness of ``tests/test_server_faults.py``, test for test, with the
port's lifecycle monitor armed.

Fault injection against the TCP engine server (``core/server.py``):
clients that vanish mid-upload or mid-task, stalled readers, framing
offenders, server shutdown under load, and reconnect semantics. Each
scenario asserts the engine's state afterwards — sessions reclaimed,
in-flight tasks drained, staged uploads discarded, other tenants
untouched — because fault containment is the server's whole job.

Also home to the cross-bridge accounting regression: endpoint_counts
count *logical* calls identically on both bridges, while the physical
frame/byte truth lives in the wire logs and per-record ``wire_nbytes``.
"""
import socket
import time

import msgpack
import numpy as np
import pytest

from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core import protocol, wire
from repro_torch.core.engine import SYSTEM_SESSION
from repro_torch.core.libraries import elemental
from repro_torch.core.scheduler import DONE, QUEUED, RUNNING
from repro_torch.core.server import AlchemistServer
from torch_bridge import stm_monitor  # noqa: F401  (armed for every test)

RNG = np.random.RandomState(11)


def _wait_until(pred, timeout=15.0, what="condition"):
    """Poll for an asynchronous cleanup to land (teardown runs on the
    connection's handler thread, not the test thread)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _session_ids(engine):
    return {s.id for s in engine.sessions()}


@pytest.fixture()
def engine():
    eng = AlchemistEngine(device="cpu", scheduler_workers=4)
    yield eng
    eng.shutdown()


@pytest.fixture()
def server(engine):
    with AlchemistServer(engine=engine) as srv:
        yield srv


def _connect_bridge(server):
    """A raw SocketBridge with an open session — no context on top, so
    tests can speak half a protocol exchange and then misbehave."""
    bridge = wire.SocketBridge(server.address)
    reply = protocol.decode_result(bridge.handshake(
        protocol.encode_handshake(protocol.Handshake(
            action=protocol.CONNECT, client="fault-test"))))
    return bridge, reply.values["session"]


# =====================================================================
# vanish mid-chunked-upload
# =====================================================================
def test_disconnect_mid_upload_discards_staged_data_and_session(
        engine, server):
    """A client that dies between BEGIN and COMMIT leaves nothing
    behind: no staged pieces, no handle, no session."""
    resident_before = engine.resident_bytes()
    sessions_before = _session_ids(engine)

    bridge, sid = _connect_bridge(server)
    assert sid in _session_ids(engine)

    begin = msgpack.packb({"shape": [64, 8], "dtype": "float32",
                           "session": sid, "name": "doomed",
                           "num_chunks": 4, "single": False})
    with bridge._lock:
        bridge._send("upload", wire.FRAME_UPLOAD_BEGIN, begin)
        _, reply = bridge._recv("upload")
    uid = protocol.decode_result(reply).values["upload"]
    chunk = np.ones((16, 8), np.float32)
    bridge._send("upload", wire.FRAME_UPLOAD_CHUNK, msgpack.packb(
        {"upload": uid, "seq": 0, "array": wire.pack_ndarray(chunk)}))

    bridge.close()                          # abrupt: no COMMIT, no bye

    _wait_until(lambda: sid not in _session_ids(engine),
                what="session reclaim after mid-upload disconnect")
    _wait_until(lambda: len(server._conns) == 0,
                what="connection teardown")
    assert _session_ids(engine) == sessions_before
    assert engine.resident_bytes() == resident_before


def test_disconnect_drains_in_flight_tasks(engine, server):
    """Vanishing with tasks QUEUED/RUNNING runs the engine's normal
    teardown: the tasks drain to a terminal state, then the session's
    handles are reclaimed — nothing is left RUNNING forever."""
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.4: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    ctx = AlchemistContext(address=server.address)
    sid = ctx.session
    fut = ctx.call_async("slow", "nap")
    assert fut.state() in (QUEUED, RUNNING, DONE)

    ctx.engine.close()                      # hang up without DISCONNECT

    _wait_until(lambda: sid not in _session_ids(engine),
                what="session reclaim after mid-task disconnect")
    # drained, not killed: the nap reached DONE before the session was
    # reclaimed (disconnect forgets the session's tasks from the live
    # scheduler table, so assert on the engine's permanent task log)
    counts = engine.scheduler.counts()
    assert counts[QUEUED] == 0 and counts[RUNNING] == 0
    summary = engine.task_log.session_summary(sid)
    assert summary["tasks"] >= 1 and summary["failed"] == 0


# =====================================================================
# tenant isolation
# =====================================================================
def test_stalled_reader_does_not_block_other_tenants(engine, server):
    """One connection parked mid-frame-header must not stall dispatch
    for anyone else — handler threads are per-connection."""
    engine.load_library("elemental", elemental)
    staller = socket.create_connection((server.host, server.port),
                                       timeout=30)
    try:
        frame = wire.encode_frame(
            wire.FRAME_HANDSHAKE, protocol.encode_handshake(
                protocol.Handshake(action=protocol.CONNECT)))
        staller.sendall(frame[:6])          # half a header, then silence

        with AlchemistContext(address=server.address) as ctx:
            x = RNG.randn(48, 6).astype(np.float32)
            al = ctx.send_matrix(x, chunk_rows=16)
            out = ctx.call("elemental", "gram", A=al.handle)
            got = ctx.fetch(out["G"]).collect()
            np.testing.assert_allclose(got, x.T @ x, rtol=1e-4,
                                       atol=1e-4)
    finally:
        staller.close()
    _wait_until(lambda: len(server._conns) == 0,
                what="stalled connection teardown")


def test_framing_fault_hangs_up_only_the_offender(engine, server):
    """Garbage bytes earn that connection a typed ERROR frame and a
    hangup; a well-behaved tenant sharing the server never notices."""
    ctx = AlchemistContext(address=server.address)
    try:
        offender = socket.create_connection((server.host, server.port),
                                            timeout=30)
        try:
            offender.sendall(b"X" * wire.HEADER_BYTES)
            rfile = offender.makefile("rb")
            got = wire.read_frame(rfile)
            assert got is not None and got[0] == wire.FRAME_ERROR
            assert isinstance(wire.decode_error(got[1]), wire.BadMagic)
            assert rfile.read(1) == b""     # offender is hung up on
        finally:
            offender.close()

        # the innocent tenant's connection still works end to end
        x = RNG.randn(12, 3).astype(np.float32)
        al = ctx.send_matrix(x)
        back = ctx.fetch(al.handle).collect()
        np.testing.assert_array_equal(back, x)
    finally:
        ctx.stop()


# =====================================================================
# shutdown and reconnect
# =====================================================================
def test_server_stop_drains_in_flight_tasks(engine):
    """``stop()`` hangs up every client; each handler's teardown waits
    for that session's tasks before reclaiming — shutdown is a drain,
    not an abort."""
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.4: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    srv = AlchemistServer(engine=engine).start()
    ctx = AlchemistContext(address=srv.address)
    sid = ctx.session
    ctx.call_async("slow", "nap")

    srv.stop()                              # engine is ours, stays up

    counts = engine.scheduler.counts()
    assert counts[QUEUED] == 0 and counts[RUNNING] == 0
    summary = engine.task_log.session_summary(sid)
    assert summary["tasks"] >= 1 and summary["failed"] == 0
    assert _session_ids(engine) == {SYSTEM_SESSION}
    # the engine survives a front-end stop and is immediately reusable
    s2 = engine.connect(client="after-stop")
    engine.disconnect(s2.id)


def test_reconnect_gets_fresh_session_namespace(engine, server):
    """A reconnecting client is a new tenant: new session id, and the
    old session's handles are gone — freed on disconnect, not parked."""
    ctx1 = AlchemistContext(address=server.address)
    sid1 = ctx1.session
    x = RNG.randn(20, 4).astype(np.float32)
    old_handle = ctx1.send_matrix(x, name="mine").handle
    ctx1.engine.close()                     # vanish, no DISCONNECT

    _wait_until(lambda: sid1 not in _session_ids(engine),
                what="first session reclaim")

    with AlchemistContext(address=server.address) as ctx2:
        assert ctx2.session != sid1
        with pytest.raises(KeyError):
            ctx2.fetch(old_handle)


# =====================================================================
# QoS backpressure faults (admission control + THROTTLE frames)
# =====================================================================
def test_vanish_while_throttled_reclaims_reservations():
    """A tenant that reserves upload quota, gets throttled on a second
    upload, then vanishes must leak nothing: its open reservation is
    reclaimed by disconnect and the full quota is available again."""
    eng = AlchemistEngine(device="cpu", qos=True,
                          qos_quotas={"max_inflight_bytes": 4096})
    try:
        with AlchemistServer(engine=eng) as srv:
            bridge, sid = _connect_bridge(srv)
            begin = msgpack.packb({"shape": [64, 8], "dtype": "float32",
                                   "session": sid, "name": None,
                                   "num_chunks": 4, "single": False})
            with bridge._lock:
                bridge._send("upload", wire.FRAME_UPLOAD_BEGIN, begin)
                ftype, reply = bridge._recv("upload")
            assert ftype == wire.FRAME_RESULT
            assert not protocol.decode_result(reply).error
            assert eng.admission.inflight_bytes(sid) == 64 * 8 * 4

            # a second BEGIN that would overflow the quota earns a
            # THROTTLE frame with a retry hint — and stages nothing
            big = msgpack.packb({"shape": [512, 8], "dtype": "float32",
                                 "session": sid, "name": None,
                                 "num_chunks": 8, "single": False})
            with bridge._lock:
                bridge._send("upload", wire.FRAME_UPLOAD_BEGIN, big)
                ftype, reply = bridge._recv("upload")
            assert ftype == wire.FRAME_THROTTLE
            res = protocol.decode_result(reply)
            assert res.error.startswith("AlchemistBusyError")
            assert res.retry_after_s > 0
            assert eng.admission.inflight_bytes(sid) == 64 * 8 * 4

            bridge.close()              # vanish: BEGIN never committed

            _wait_until(lambda: sid not in _session_ids(eng),
                        what="session reclaim after throttled vanish")
            _wait_until(lambda: eng.admission.inflight_bytes(sid) == 0,
                        what="upload reservation reclaim")

            # the quota is whole again for the next tenant
            bridge2, sid2 = _connect_bridge(srv)
            with bridge2._lock:
                bridge2._send("upload", wire.FRAME_UPLOAD_BEGIN,
                              msgpack.packb(
                                  {"shape": [128, 8], "dtype": "float32",
                                   "session": sid2, "name": None,
                                   "num_chunks": 4, "single": False}))
                ftype, reply = bridge2._recv("upload")
            assert ftype == wire.FRAME_RESULT
            assert not protocol.decode_result(reply).error
            bridge2.close()
    finally:
        eng.shutdown()


def test_throttle_frame_from_client_is_refused(engine, server):
    """THROTTLE is a reply-role frame: a client sending one as a request
    gets the typed unknown-request ERROR, and nobody else notices."""
    ctx = AlchemistContext(address=server.address)
    try:
        offender = socket.create_connection((server.host, server.port),
                                            timeout=30)
        try:
            offender.sendall(wire.encode_frame(wire.FRAME_THROTTLE, b""))
            rfile = offender.makefile("rb")
            got = wire.read_frame(rfile)
            assert got is not None and got[0] == wire.FRAME_ERROR
            err = wire.decode_error(got[1])
            assert isinstance(err, wire.UnknownFrameType)
            assert "not a request" in str(err)
        finally:
            offender.close()

        # the innocent tenant's connection still works end to end
        x = RNG.randn(12, 3).astype(np.float32)
        al = ctx.send_matrix(x)
        back = ctx.fetch(al.handle).collect()
        np.testing.assert_array_equal(back, x)
    finally:
        ctx.stop()


# =====================================================================
# accounting: logical counts vs physical frames (satellite regression)
# =====================================================================
def _workload(ctx):
    x = np.arange(40 * 6, dtype=np.float32).reshape(40, 6)
    al = ctx.send_matrix(x, chunk_rows=16)
    out = ctx.call("elemental", "gram", A=al.handle)
    ctx.fetch(out["G"])
    ctx.send_matrix(x, chunk_rows=16)       # warm: dedup short-circuit
    return al


def test_endpoint_counts_stay_logical_on_both_bridges():
    """The same workload produces byte-identical protocol traffic on
    both bridges, so the engine's endpoint_counts — logical calls — must
    match exactly; the socket's extra physical cost shows up only in the
    wire logs and per-record wire_nbytes."""
    eng_mem = AlchemistEngine(device="cpu")
    eng_mem.load_library("elemental", elemental)
    with AlchemistContext(engine=eng_mem) as ctx:
        al_mem = _workload(ctx)
        counts_mem = dict(eng_mem.endpoint_counts)
        # in-memory transfers never touch a socket: wire_nbytes stays 0
        assert al_mem.last_transfer.wire_nbytes == 0
    eng_mem.shutdown()

    eng_sock = AlchemistEngine(device="cpu")
    eng_sock.load_library("elemental", elemental)
    with AlchemistServer(engine=eng_sock) as srv:
        with AlchemistContext(address=srv.address) as ctx:
            upload_frames = srv.wire_log.stat("upload").frames_in
            al_sock = _workload(ctx)
            counts_sock = dict(eng_sock.endpoint_counts)

            # logical crossings are identical across transports
            assert counts_sock == counts_mem

            # physical truth: the chunked upload cost more bytes on the
            # wire than the matrix holds (framing + headers), and every
            # touched endpoint has measured traffic on both ends
            rec = al_sock.last_transfer
            assert rec.wire_nbytes > rec.nbytes > 0
            for endpoint in ("handshake", "submit", "upload", "fetch"):
                assert srv.wire_log.stat(endpoint).frames_in > 0
                assert ctx.engine.wire_log.stat(endpoint).frames_out > 0

            # warm re-upload deduped: its one crossing was the
            # alias-lookup probe, not upload frames
            warm = eng_sock.transfer_log.records[-1]
            assert warm.dedup and warm.nbytes == 0
            assert 0 < warm.wire_nbytes < rec.nbytes
            frames_now = srv.wire_log.stat("upload").frames_in
            cold_frames = 2 + 3             # BEGIN/COMMIT + 3 chunks
            assert frames_now - upload_frames == cold_frames
    eng_sock.shutdown()
