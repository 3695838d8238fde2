"""The port's sessions and streaming (``repro_torch.core``) under the
tests of ``tests/test_sessions_streaming.py``, test for test, over both
bridges: the in-memory engine and the port's TCP server.

Tests for the multi-session streaming engine: the connect/disconnect
handshake, per-session handle namespaces, the chunked §3.2 transfer path,
and the handle lifecycle layer (refcounts, LRU spill, free_session)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core import protocol, transfer
from repro_torch.core.context import AlchemistError
from repro_torch.core.engine import SYSTEM_SESSION
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import elemental, skylark
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(0)


@pytest.fixture()
def engine():
    eng = AlchemistEngine(device="cpu")
    yield eng
    eng.shutdown()


# ---- protocol: session fields and error results round-trip ----
def test_handshake_roundtrip():
    hs = protocol.Handshake(action=protocol.CONNECT, client="spark-7")
    back = protocol.decode_handshake(protocol.encode_handshake(hs))
    assert back == hs
    bye = protocol.Handshake(action=protocol.DISCONNECT, session=42)
    assert protocol.decode_handshake(protocol.encode_handshake(bye)) == bye


def test_handshake_rejects_unknown_action():
    with pytest.raises(ValueError):
        protocol.encode_handshake(protocol.Handshake(action="reconnect"))


def test_result_roundtrip_preserves_session_and_error():
    h = MatrixHandle.fresh((2, 3), "float32")
    res = protocol.Result(values={"A": h}, elapsed=1.5,
                          error="KeyError: nope", session=9)
    back = protocol.decode_result(protocol.encode_result(res))
    assert back == res
    assert back.session == 9 and back.error == "KeyError: nope"


def test_command_session_roundtrip():
    cmd = protocol.Command("lib", "fn", {"k": 1}, session=12)
    assert protocol.decode_command(protocol.encode_command(cmd)).session == 12


# ---- session lifecycle ----
def test_connect_mints_distinct_sessions(engine):
    a = AlchemistContext(engine=engine, client_name="a")
    b = AlchemistContext(engine=engine, client_name="b")
    assert a.session != b.session
    assert a.session != SYSTEM_SESSION
    ids = {s.id for s in engine.sessions()}
    assert {SYSTEM_SESSION, a.session, b.session} <= ids


def test_wire_commands_cannot_claim_the_system_session(engine):
    """A client forging session=0 must not reach the system namespace."""
    engine.load_library("elemental", elemental)
    wire = protocol.encode_command(protocol.Command(
        "elemental", "random_matrix", {"rows": 4, "cols": 4}, session=0))
    res = protocol.decode_result(engine.run(wire))
    assert "system session" in res.error


def test_cross_session_free_raises_not_silently_noops(engine):
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    h = a.send_matrix(RNG.randn(4, 4)).handle
    with pytest.raises(KeyError, match="not visible"):
        b.free(h)
    assert engine.refcount(h) == 1


def test_command_for_unknown_session_errors(engine):
    engine.load_library("elemental", elemental)
    wire = protocol.encode_command(protocol.Command(
        "elemental", "random_matrix", {"rows": 4, "cols": 4}, session=999))
    res = protocol.decode_result(engine.run(wire))
    assert "UnknownSession" in res.error and res.session == 999


def test_engine_rejects_bogus_handshake_wire(engine):
    import msgpack

    res = protocol.decode_result(engine.handshake(
        msgpack.packb({"action": "party", "session": 0})))
    assert "ValueError" in res.error
    # the system session must survive any handshake
    assert any(s.id == SYSTEM_SESSION for s in engine.sessions())
    res2 = protocol.decode_result(engine.handshake(
        msgpack.packb({"action": "disconnect", "session": 0})))
    assert "system session" in res2.error


def test_nonpositive_chunk_rows_clamps_to_single_rows(engine):
    x = RNG.randn(10, 3).astype(np.float32)
    for bad in (0, -5):
        h, rec = transfer.to_engine(engine, x, chunk_rows=bad)
        assert rec.num_chunks == 10
        np.testing.assert_array_equal(np.asarray(engine.get(h)), x)


def test_disconnect_reclaims_session_handles(engine):
    ac = AlchemistContext(engine=engine)
    ac.send_matrix(RNG.randn(32, 8))
    ac.send_matrix(RNG.randn(16, 4))
    assert engine.resident_bytes() > 0
    ac.stop()
    assert engine.resident_bytes() == 0
    # session is gone from the table; stop() is idempotent
    assert all(s.id != ac.session for s in engine.sessions())
    ac.stop()


def test_free_session_counts_entries(engine):
    ac = AlchemistContext(engine=engine)
    ac.send_matrix(RNG.randn(8, 8))
    ac.send_matrix(RNG.randn(8, 8))
    assert engine.free_session(ac.session) == 2
    assert engine.free_session(ac.session) == 0


# ---- two concurrent sessions with isolated namespaces ----
def test_two_clients_full_flow_isolated(engine):
    """Acceptance: two contexts on one engine each send -> run -> fetch
    with isolated handle tables."""
    engine.load_library("elemental", elemental)
    engine.load_library("skylark", skylark)
    a = AlchemistContext(engine=engine, client_name="a")
    b = AlchemistContext(engine=engine, client_name="b")

    xa = RNG.randn(120, 24)
    al_a = a.send_matrix(xa)
    res_a = a.call("elemental", "truncated_svd", A=al_a, k=4)

    xb = RNG.randn(80, 10).astype(np.float32)
    yb = RNG.randn(80, 2).astype(np.float32)
    res_b = b.call("skylark", "cg_solve", X=b.send_matrix(xb),
                   Y=b.send_matrix(yb), lam=1e-3, max_iters=300, tol=1e-10)

    s = a.wrap(res_a["S"]).to_numpy().ravel()
    np.testing.assert_allclose(
        s, np.linalg.svd(xa, compute_uv=False)[:4], rtol=1e-4)
    w = b.wrap(res_b["W"]).to_numpy()
    want = np.linalg.solve(xb.T @ xb + 80 * 1e-3 * np.eye(10), xb.T @ yb)
    np.testing.assert_allclose(w, want, atol=1e-4)

    # cross-session access is refused at the dispatch boundary
    with pytest.raises(AlchemistError, match="not visible in session"):
        b.call("elemental", "qr", A=al_a.handle)
    with pytest.raises(KeyError, match="not visible"):
        b.fetch(al_a.handle)
    a.stop()
    b.stop()


def test_sessions_do_not_clobber_same_named_handles(engine):
    engine.load_library("elemental", elemental)
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    ra = a.call("elemental", "random_matrix", rows=8, cols=8, seed=1,
                name="shared-name")
    rb = b.call("elemental", "random_matrix", rows=8, cols=8, seed=2,
                name="shared-name")
    assert ra["A"].id != rb["A"].id
    va = a.wrap(ra["A"]).to_numpy()
    vb = b.wrap(rb["A"]).to_numpy()
    assert not np.allclose(va, vb)


def test_serialized_dispatch_under_threads(engine):
    """Concurrent clients' commands all execute, strictly one at a time."""
    engine.load_library("elemental", elemental)
    ctxs = [AlchemistContext(engine=engine) for _ in range(3)]
    errors = []

    def work(ac, seed):
        try:
            for i in range(4):
                res = ac.call("elemental", "random_matrix", rows=16,
                              cols=8, seed=seed * 10 + i)
                g = ac.call("elemental", "gram", A=res["A"])
                assert g["G"].shape == (8, 8)
        except Exception as e:  # pragma: no cover - surfaced via errors
            errors.append(e)

    threads = [threading.Thread(target=work, args=(ac, i))
               for i, ac in enumerate(ctxs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    counts = {s.id: s.commands for s in engine.sessions()}
    assert all(counts[ac.session] == 8 for ac in ctxs)


# ---- chunked streaming transfer ----
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (103, 17), (128, 32),
                                   (257, 5)])
@pytest.mark.parametrize("chunk_rows", [1, 8, 37, 10_000])
def test_chunked_equals_single_shot_bit_exact(engine, shape, chunk_rows):
    x = RNG.randn(*shape).astype(np.float32)
    h_stream, rec = transfer.to_engine(engine, x, chunk_rows=chunk_rows)
    h_single, _ = transfer.to_engine(engine, x, chunk_rows=10**9)
    a = np.asarray(engine.get(h_stream))
    b = np.asarray(engine.get(h_single))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, x)
    expected_chunks = -(-shape[0] // chunk_rows)
    assert rec.num_chunks == expected_chunks


def test_unserializable_routine_output_errors_without_desyncing(engine):
    """A routine returning a value the protocol refuses to serialize must
    come back as an error Result, and the dispatch queue must keep
    serving later commands (one bad command cannot strand the queue)."""
    class _BadLib:
        ROUTINES = {"bad": lambda eng: {"A": np.zeros(3)}}

    engine.load_library("bad", _BadLib)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    with pytest.raises(AlchemistError, match="TypeError"):
        ac.call("bad", "bad")
    res = ac.call("elemental", "random_matrix", rows=4, cols=4)
    assert res["A"].shape == (4, 4)


def test_undecodable_wire_bytes_return_error_result(engine):
    res = protocol.decode_result(engine.run(b"\x00garbage"))
    assert res.error


def test_send_returns_aggregate_record(engine):
    """The returned record summarizes the whole stream, not one chunk."""
    x = RNG.randn(100, 10).astype(np.float32)
    _, rec = transfer.to_engine(engine, x, chunk_rows=33)
    assert rec.nbytes == x.nbytes
    assert rec.num_chunks == 4 and rec.chunk_index == -1
    assert rec.modeled_socket_s > 0


def test_rowmatrix_source_streams_without_collect(engine, monkeypatch):
    """A RowMatrix crosses partition-by-partition — collect() never runs."""
    from repro_torch.frontend.rowmatrix import RowMatrix

    x = RNG.randn(60, 5)
    rm = RowMatrix.from_array(x, num_partitions=4)

    def _no_collect():
        raise AssertionError("collect() called")

    monkeypatch.setattr(rm, "collect", _no_collect)
    h, rec = transfer.to_engine(engine, rm, chunk_rows=7)
    # f64 lands as f32, as JAX canonicalizes it on device_put, so
    # compare against the f32 cast.
    np.testing.assert_array_equal(np.asarray(engine.get(h)),
                                  x.astype(np.float32))
    assert rec.nbytes == x.nbytes


def test_per_chunk_records_sum_to_matrix_bytes(engine):
    before = len(engine.transfer_log.records)
    x = RNG.randn(100, 10).astype(np.float32)
    transfer.to_engine(engine, x, chunk_rows=33, session=SYSTEM_SESSION)
    recs = engine.transfer_log.records[before:]
    assert len(recs) == 4                      # 33+33+33+1 rows
    assert sum(r.nbytes for r in recs) == x.nbytes
    assert [r.chunk_index for r in recs] == [0, 1, 2, 3]
    assert all(r.num_chunks == 4 for r in recs)


def test_fetch_streams_back_bit_exact(engine):
    ac = AlchemistContext(engine=engine, chunk_rows=9)
    x = RNG.randn(50, 11).astype(np.float32)
    al = ac.send_matrix(x)
    back = ac.fetch(al.handle, chunk_rows=13).collect()
    np.testing.assert_array_equal(back, x)


def test_rowmatrix_iter_row_blocks_rechunks():
    from repro_torch.frontend.rowmatrix import RowMatrix

    x = RNG.randn(53, 4)
    rm = RowMatrix.from_array(x, num_partitions=7)
    blocks = list(rm.iter_row_blocks(10))
    assert [b.shape[0] for b in blocks] == [10, 10, 10, 10, 10, 3]
    np.testing.assert_array_equal(np.concatenate(blocks), x)


# ---- handle lifecycle: refcounts, LRU spill, reload ----
def test_session_can_read_but_not_free_system_handles(engine):
    h = engine.put(np.ones((4, 4), np.float32))    # system-owned
    ac = AlchemistContext(engine=engine)
    np.testing.assert_array_equal(                 # readable (shared input)
        engine.get(h, session=ac.session), np.ones((4, 4), np.float32))
    with pytest.raises(KeyError, match="may read"):
        ac.free(h)
    assert engine.refcount(h) == 1                 # untouched


def test_command_wire_requires_session_field():
    import msgpack

    wire = msgpack.packb({"library": "l", "routine": "r", "args": {}})
    with pytest.raises(KeyError):
        protocol.decode_command(wire)


def test_device_tensor_input_takes_direct_path(engine):
    before = len(engine.transfer_log.records)
    x = torch.ones((64, 8), dtype=torch.float32)
    h, rec = transfer.to_engine(engine, x, chunk_rows=4)
    assert len(engine.transfer_log.records) == before + 1   # one record
    assert rec.num_chunks == 1
    np.testing.assert_array_equal(np.asarray(engine.get(h)), np.asarray(x))


def test_refcount_retain_release(engine):
    h = engine.put(np.zeros((4, 4), np.float32))
    assert engine.refcount(h) == 1
    engine.retain(h)
    engine.free(h)
    assert engine.refcount(h) == 1             # still one ref left
    engine.get(h)                              # still resolvable
    engine.free(h)
    assert engine.refcount(h) == 0
    with pytest.raises(KeyError, match="not resident"):
        engine.get(h)


def test_lru_eviction_spills_oldest_and_reload_is_exact():
    nbytes = 100 * 100 * 4
    engine = AlchemistEngine(device="cpu",
                             memory_budget_bytes=3 * nbytes)
    mats = [RNG.randn(100, 100).astype(np.float32) for _ in range(5)]
    handles = [engine.put(m) for m in mats]
    assert engine.resident_bytes() <= 3 * nbytes
    assert engine.spilled_bytes() == 2 * nbytes
    # the two least-recently-used (first puts) were spilled
    assert engine.is_spilled(handles[0]) and engine.is_spilled(handles[1])
    # transparent reload returns exact data and re-enforces the budget
    np.testing.assert_array_equal(np.asarray(engine.get(handles[0])),
                                  mats[0])
    assert not engine.is_spilled(handles[0])
    assert engine.resident_bytes() <= 3 * nbytes
    # every matrix survives arbitrary access order bit-exactly
    for h, m in zip(handles, mats):
        np.testing.assert_array_equal(np.asarray(engine.get(h)), m)


def test_eviction_interacts_with_routines():
    """A spilled input reloads transparently when a routine resolves it."""
    nbytes = 64 * 16 * 4
    engine = AlchemistEngine(device="cpu",
                             memory_budget_bytes=2 * nbytes)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    x = RNG.randn(64, 16).astype(np.float32)
    al = ac.send_matrix(x)
    ac.send_matrix(RNG.randn(64, 16))          # pressure
    ac.send_matrix(RNG.randn(64, 16))          # evicts al's array
    assert engine.is_spilled(al.handle)
    res = ac.call("elemental", "gram", A=al)
    g = ac.wrap(res["G"]).to_numpy()
    np.testing.assert_allclose(g, x.T @ x, atol=1e-3)
