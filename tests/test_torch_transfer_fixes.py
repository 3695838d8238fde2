"""The port's transfer layer (``repro_torch.core.transfer``) under the
sweep of ``tests/test_transfer_fixes.py``, test for test, over both
bridges, plus the bfloat16 round trip held against the JAX package
(ROADMAP C5).

Transfer-layer correctness sweep: dtype-aware chunk sizing (float32
matrices were getting 2x-oversized chunks and 2x-inflated modeled costs),
bounded-memory to_client streaming (no whole-matrix staging buffer), and
aggregate stream records agreeing with the sum of their per-chunk records
even when shard-boundary cuts leave runt chunks."""
import numpy as np
import pytest
import torch

from repro_torch.core import AlchemistContext, AlchemistEngine, transfer
from repro_torch.core import wire
from repro_torch.frontend.rowmatrix import RowMatrix
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(3)


@pytest.fixture()
def engine():
    eng = AlchemistEngine(device="cpu")
    yield eng
    eng.shutdown()


# =====================================================================
# dtype tracking (the float32 regression)
# =====================================================================
def test_rowmatrix_tracks_dtype_and_nbytes():
    x32 = RNG.randn(50, 10).astype(np.float32)
    rm = RowMatrix.from_array(x32, 4)
    assert rm.dtype == np.float32
    assert rm.nbytes == 50 * 10 * 4                 # not * 8
    rm64 = RowMatrix.from_array(x32.astype(np.float64), 4)
    assert rm64.nbytes == 50 * 10 * 8
    assert RowMatrix.random(20, 5).dtype == np.float64


def test_map_rows_derives_dtype_lazily():
    rm = RowMatrix.from_array(RNG.randn(40, 8), 4)
    mapped = rm.map_rows(lambda p: p.astype(np.float32))
    assert mapped._dtype is None                    # not eagerly computed
    assert mapped.dtype == np.float32
    assert mapped.nbytes == 40 * 8 * 4


def test_float32_rowmatrix_chunks_sized_by_real_itemsize(engine):
    """1024x1024 f32 is exactly DEFAULT_CHUNK_BYTES: with the real 4-byte
    itemsize it crosses as ONE chunk; the old hardcoded itemsize=8 halved
    chunk_rows and produced two."""
    x = RNG.randn(1024, 1024).astype(np.float32)
    rm = RowMatrix.from_array(x, 4)
    handle, rec = transfer.to_engine(engine, rm)
    assert rec.num_chunks == 1
    assert rec.nbytes == x.nbytes == 1024 * 1024 * 4
    chunk_recs = [r for r in engine.transfer_log.records
                  if r.chunk_index >= 0]
    assert sum(r.nbytes for r in chunk_recs) == x.nbytes
    np.testing.assert_array_equal(np.asarray(engine.get(handle)), x)


def test_float32_roundtrip_preserves_dtype_and_values(engine):
    ac = AlchemistContext(engine=engine)
    x = RNG.randn(100, 16).astype(np.float32)
    al = ac.send_matrix(x, chunk_rows=13)
    back = al.to_row_matrix(num_partitions=5)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.collect(), x)


def test_chunk_rows_for_uses_itemsize():
    assert transfer.chunk_rows_for((1000, 1024), 4) == \
        2 * transfer.chunk_rows_for((1000, 1024), 8)


# =====================================================================
# to_client streaming (bounded peak host memory)
# =====================================================================
def test_to_client_never_allocates_a_full_matrix_buffer(engine,
                                                        monkeypatch):
    """Chunks land directly in per-partition blocks: the largest single
    host allocation is one partition, and the total allocated equals the
    matrix itself — no extra whole-matrix staging buffer."""
    x = RNG.randn(200, 32).astype(np.float32)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(x)

    allocs = []
    real_empty = np.empty

    def recording_empty(shape, *a, **kw):
        out = real_empty(shape, *a, **kw)
        allocs.append(out.nbytes)
        return out

    monkeypatch.setattr(transfer.np, "empty", recording_empty)
    rm = ac.fetch(al.handle, num_partitions=8, chunk_rows=17)
    monkeypatch.undo()

    assert allocs, "to_client should allocate its partition blocks"
    max_partition_bytes = -(-200 // 8) * 32 * 4
    assert max(allocs) <= max_partition_bytes     # never the full matrix
    assert sum(allocs) == x.nbytes                # exactly the result
    np.testing.assert_array_equal(rm.collect(), x)


def test_to_client_partitioning_matches_array_split(engine):
    """Partition sizes must stay what from_array produced (np.array_split
    semantics) so downstream per-partition consumers see no change."""
    ac = AlchemistContext(engine=engine)
    x = RNG.randn(100, 8)
    al = ac.send_matrix(x)
    rm = ac.fetch(al.handle, num_partitions=8)
    want_sizes = [b.shape[0] for b in np.array_split(x, 8, axis=0)]
    got_sizes = [np.asarray(rm.rdd.partition(i)).shape[0]
                 for i in range(rm.rdd.num_partitions)]
    assert got_sizes == want_sizes
    assert rm.row_offsets == [0] + list(np.cumsum(want_sizes))


def test_to_client_one_dim_handle(engine):
    """Singular-value vectors (1-D handles) still round-trip."""
    ac = AlchemistContext(engine=engine)
    h = engine.put(torch.arange(37, dtype=torch.float32))
    got = ac.wrap(h).to_numpy()
    np.testing.assert_array_equal(got, np.arange(37, dtype=np.float32))


# =====================================================================
# aggregate record == sum of per-chunk records (runt chunks)
# =====================================================================
@pytest.mark.parametrize("direction", ["to_engine", "to_client"])
def test_aggregate_matches_per_chunk_sum_with_runts(engine, direction):
    """100 rows at chunk_rows=33 leaves a 1-row runt: the aggregate's
    stream model must be built from the actual chunk list, not a mean
    chunk size, so it equals the per-chunk records' sum exactly."""
    x = RNG.randn(100, 8)
    if direction == "to_engine":
        _, agg = transfer.to_engine(engine, x, chunk_rows=33)
    else:
        handle, _ = transfer.to_engine(engine, x, chunk_rows=10**9)
        engine.transfer_log.records.clear()
        _, agg = transfer.to_client(engine, handle, num_partitions=1,
                                    chunk_rows=33)
    chunk_recs = [r for r in engine.transfer_log.records
                  if r.chunk_index >= 0 and r.direction == direction]
    # client side streams the f64 source; the engine tensor is f32 (as
    # JAX's with x64 off), so the fetch direction moves half the bytes
    # per row
    row_bytes = 8 * 8 if direction == "to_engine" else 8 * 4
    assert [r.nbytes for r in chunk_recs] == \
        [33 * row_bytes] * 3 + [1 * row_bytes]
    assert agg.num_chunks == len(chunk_recs) == 4
    assert agg.nbytes == sum(r.nbytes for r in chunk_recs)
    np.testing.assert_allclose(
        agg.modeled_socket_s,
        sum(r.modeled_socket_s for r in chunk_recs), rtol=1e-12)


def test_uniform_chunks_agree_with_uniform_stream_model(engine):
    """When chunks ARE uniform, the chunk-list model reduces to the
    uniform-chunk stream model the Table-3 sweep uses."""
    from repro_torch.core.costmodel import (
        stream_transfer_seconds, stream_transfer_seconds_from_chunks)
    sizes = [1 << 20] * 8
    np.testing.assert_allclose(
        stream_transfer_seconds_from_chunks(sizes, 20, 20),
        stream_transfer_seconds(8 << 20, 1 << 20, 20, 20), rtol=1e-12)


# =====================================================================
# bfloat16 crosses as bfloat16 (ROADMAP C5)
# =====================================================================
def test_bfloat16_store_comes_back_as_bfloat16_like_the_reference(
        engine, bridge_mode):
    """A bf16 matrix sent and fetched back keeps its dtype, its values and
    its width: each ``to_client`` record counts the bf16 bytes, as the JAX
    package's (over its own bridge of the same kind) does."""
    import ml_dtypes
    from repro.core import AlchemistContext as RefContext, \
        AlchemistEngine as RefEngine
    from repro.core.engine import make_engine_mesh
    from repro.core.server import AlchemistServer as RefServer

    x = (np.arange(12, dtype=np.float32).reshape(4, 3) / 7).astype(
        ml_dtypes.bfloat16)

    def probe(ac, eng):
        n0 = len(eng.transfer_log.records)
        al = ac.send_matrix(x)
        assert al.dtype == "bfloat16"
        back = al.to_numpy()
        return back, [r.nbytes for r in eng.transfer_log.records[n0:]
                      if r.direction == "to_client"]

    ac = AlchemistContext(engine=engine)
    assert isinstance(ac.engine, wire.SocketBridge) == \
        (bridge_mode == "socket")
    got, got_recs = probe(ac, engine)
    ac.stop()

    ref_eng = RefEngine(make_engine_mesh(1))
    if bridge_mode == "socket":
        with RefServer(engine=ref_eng) as srv:
            with RefContext(address=srv.address) as ref:
                want, want_recs = probe(ref, ref_eng)
    else:
        with RefContext(engine=ref_eng) as ref:
            want, want_recs = probe(ref, ref_eng)
    ref_eng.shutdown()

    assert got.dtype == want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))
    np.testing.assert_array_equal(got.view(np.int16), x.view(np.int16))
    assert got_recs == want_recs == [6, 6, 6, 6]
