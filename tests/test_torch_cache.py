"""The port's result and transfer cache (``repro_torch.core.cache``) under
the tests of ``tests/test_cache.py``, test for test, over both bridges,
with chain fusion on.

Content-addressed cache semantics: hit/miss keys, invalidation on
overwrite and forced free, cross-session isolation (cached results are
aliased, never leaked, across namespaces), dedup-upload aliasing with
zero-byte crossings, interaction with LRU spill and the cache's own LRU,
and cache lookups racing the scheduler's hazard edges."""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import AlchemistContext, AlchemistEngine, protocol
from repro_torch.core.context import AlchemistError
from repro_torch.core.libraries import elemental, skylark
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(7)


@pytest.fixture()
def engine():
    eng = AlchemistEngine(device="cpu", scheduler_workers=4)
    eng.load_library("elemental", elemental)
    eng.load_library("skylark", skylark)
    return eng


@pytest.fixture()
def ac(engine):
    return AlchemistContext(engine=engine)


# =====================================================================
# hit/miss keys
# =====================================================================
def test_identical_call_hits_and_returns_same_handles(ac, engine):
    al = ac.send_matrix(RNG.randn(64, 16).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    r2 = ac.call("elemental", "gram", A=al)
    assert not r1["_cache_hit"] and r2["_cache_hit"]
    assert r2["G"].id == r1["G"].id          # same session: same handles
    assert r2["_saved_s"] > 0
    log = engine.cache_log.session_summary(ac.session)
    assert log["hits"] == 1 and log["misses"] == 1
    np.testing.assert_allclose(ac.wrap(r2["G"]).to_numpy(),
                               ac.wrap(r1["G"]).to_numpy())


def test_param_change_misses(ac):
    al = ac.send_matrix(RNG.randn(64, 16).astype(np.float32))
    r1 = ac.call("elemental", "truncated_svd", A=al, k=4)
    r2 = ac.call("elemental", "truncated_svd", A=al, k=5)
    assert not r1["_cache_hit"] and not r2["_cache_hit"]
    r3 = ac.call("elemental", "truncated_svd", A=al, k=4)
    assert r3["_cache_hit"]


def test_different_content_misses(ac):
    a = ac.send_matrix(RNG.randn(32, 8).astype(np.float32))
    b = ac.send_matrix(RNG.randn(32, 8).astype(np.float32))
    assert not ac.call("elemental", "gram", A=a)["_cache_hit"]
    assert not ac.call("elemental", "gram", A=b)["_cache_hit"]


def test_same_content_different_handles_hit(ac):
    """Content addressing, not handle addressing: two uploads of equal
    bytes (the second is a dedup alias) share one cache key."""
    x = RNG.randn(48, 12).astype(np.float32)
    a = ac.send_matrix(x)
    b = ac.send_matrix(x)                    # dedup alias, different id
    assert b.handle.id != a.handle.id
    assert not ac.call("elemental", "gram", A=a)["_cache_hit"]
    assert ac.call("elemental", "gram", A=b)["_cache_hit"]


def test_creation_routines_are_not_memoized(ac, engine):
    """Commands with no handle args (random_matrix, test shims) are not
    cached: every call runs."""
    r1 = ac.call("elemental", "random_matrix", rows=16, cols=4, seed=3)
    r2 = ac.call("elemental", "random_matrix", rows=16, cols=4, seed=3)
    assert not r1["_cache_hit"] and not r2["_cache_hit"]
    assert r2["A"].id != r1["A"].id


def test_write_routines_are_not_memoized(engine, ac):
    def scale(eng, A, factor=2.0):
        eng.overwrite(A, eng.get(A) * factor)
        return {"A": A}
    scale.writes = ("A",)

    class _Lib:
        ROUTINES = {"scale": scale}

    engine.load_library("w", _Lib)
    al = ac.send_matrix(np.ones((8, 2), np.float32))
    ac.call("w", "scale", A=al, factor=3.0)
    ac.call("w", "scale", A=al, factor=3.0)  # must run again
    np.testing.assert_allclose(np.asarray(engine.get(al.handle)),
                               9.0 * np.ones((8, 2), np.float32))


# =====================================================================
# DONE-on-submit fast path
# =====================================================================
def test_fast_path_mints_no_task(ac, engine):
    al = ac.send_matrix(RNG.randn(32, 8).astype(np.float32))
    ac.call("elemental", "qr", A=al)
    tasks_before = len(engine.task_log.records)
    fut = ac.call_async("elemental", "qr", A=al)
    assert fut.done() and fut.state() == "DONE"
    out = fut.result()
    assert out["_cache_hit"] and fut.task == 0
    assert len(engine.task_log.records) == tasks_before  # no task ran
    # outputs resolve to real handles immediately
    assert out["Q"].shape == (32, 8)


def test_hit_survives_engine_restartless_wire_roundtrip(ac, engine):
    """The wire Result of a fast-path hit carries cache_hit/saved_s."""
    al = ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
    ac.call("elemental", "gram", A=al)
    wire = protocol.encode_command(protocol.Command(
        "elemental", "gram", {"A": al.handle}, session=ac.session))
    res = protocol.decode_result(engine.run(wire))
    assert res.cache_hit and res.saved_s > 0 and res.state == "DONE"
    assert res.task == 0 and not res.error


# =====================================================================
# invalidation: overwrite / free
# =====================================================================
def test_overwrite_of_input_invalidates(ac, engine):
    x = np.ones((8, 4), np.float32)
    al = ac.send_matrix(x)
    r1 = ac.call("elemental", "gram", A=al)
    engine.overwrite(al.handle, 2 * np.ones((8, 4), np.float32))
    r2 = ac.call("elemental", "gram", A=al)
    assert not r2["_cache_hit"]
    np.testing.assert_allclose(ac.wrap(r2["G"]).to_numpy(),
                               4.0 * (x.T @ x), rtol=1e-5)
    assert r1["G"].id != r2["G"].id


def test_overwrite_of_output_invalidates(ac, engine):
    al = ac.send_matrix(RNG.randn(8, 4).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    engine.overwrite(r1["G"], np.zeros((4, 4), np.float32))
    r2 = ac.call("elemental", "gram", A=al)
    assert not r2["_cache_hit"]              # entry died with its output
    assert engine.cache_log.summary()["invalidations"] >= 1


def test_client_free_does_not_invalidate(ac, engine):
    """The cache retains its outputs: a client free drops the client's
    reference but the memoized result keeps serving."""
    al = ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    ac.free(r1["G"])                         # client lets go
    r2 = ac.call("elemental", "gram", A=al)
    assert r2["_cache_hit"]
    # content still correct after the free
    np.testing.assert_allclose(
        ac.wrap(r2["G"]).to_numpy(),
        np.asarray(engine.get(al.handle)).T
        @ np.asarray(engine.get(al.handle)), rtol=1e-4, atol=1e-4)


def test_forced_reclaim_invalidates(ac, engine):
    al = ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    # trusted path frees both references (client's + cache's): reclaimed
    engine.free(r1["G"])
    engine.free(r1["G"])
    r2 = ac.call("elemental", "gram", A=al)
    assert not r2["_cache_hit"]


def test_lru_spill_does_not_invalidate():
    """A spilled cached output transparently reloads on a hit."""
    nbytes = 64 * 16 * 4
    engine = AlchemistEngine(device="cpu",
                             memory_budget_bytes=2 * nbytes)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(RNG.randn(64, 16).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    # push the cached output out of device memory
    for i in range(3):
        ac.send_matrix(RNG.randn(64, 16).astype(np.float32))
    assert engine.spilled_bytes() > 0
    r2 = ac.call("elemental", "gram", A=al)
    assert r2["_cache_hit"] and r2["G"].id == r1["G"].id
    assert ac.wrap(r2["G"]).to_numpy().shape == (16, 16)


def test_cache_lru_eviction_releases_refs():
    engine = AlchemistEngine(device="cpu", cache_entries=2)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    als = [ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
           for _ in range(3)]
    outs = [ac.call("elemental", "gram", A=al) for al in als]
    # third store evicted the first entry; its retained ref was released
    assert engine.refcount(outs[0]["G"]) == 1       # client's ref only
    assert engine.refcount(outs[2]["G"]) == 2       # client + cache
    assert not ac.call("elemental", "gram", A=als[0])["_cache_hit"]
    assert ac.call("elemental", "gram", A=als[2])["_cache_hit"]


# =====================================================================
# cross-session isolation
# =====================================================================
def test_cross_session_hit_aliases_not_leaks(engine):
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    x = RNG.randn(32, 8).astype(np.float32)
    ra = a.call("elemental", "qr", A=a.send_matrix(x))
    rb = b.call("elemental", "qr", A=b.send_matrix(x))
    assert rb["_cache_hit"]
    # B got fresh handle IDs in ITS namespace, not A's handles
    assert rb["Q"].id != ra["Q"].id and rb["R"].id != ra["R"].id
    assert rb["Q"].id in engine.session(b.session).owned
    assert rb["Q"].id not in engine.session(a.session).owned
    np.testing.assert_allclose(b.wrap(rb["Q"]).to_numpy(),
                               a.wrap(ra["Q"]).to_numpy())
    # A cannot resolve B's alias and vice versa
    with pytest.raises(AlchemistError):
        a.call("elemental", "gram", A=rb["Q"])
    with pytest.raises(AlchemistError):
        b.call("elemental", "gram", A=ra["Q"])


def test_producer_disconnect_keeps_consumer_aliases_alive(engine):
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    x = RNG.randn(16, 4).astype(np.float32)
    a.call("elemental", "gram", A=a.send_matrix(x))
    rb = b.call("elemental", "gram", A=b.send_matrix(x))
    assert rb["_cache_hit"]
    a.stop()                       # producer leaves; B's aliases survive
    np.testing.assert_allclose(b.wrap(rb["G"]).to_numpy(), x.T @ x,
                               rtol=1e-4, atol=1e-4)
    b.stop()
    assert engine.resident_bytes() == 0


def test_disconnect_invalidates_the_sessions_cached_results(engine):
    a = AlchemistContext(engine=engine)
    x = RNG.randn(16, 4).astype(np.float32)
    a.call("elemental", "gram", A=a.send_matrix(x))
    a.stop()
    # a later tenant with the same content recomputes (no dangling entry)
    b = AlchemistContext(engine=engine)
    rb = b.call("elemental", "gram", A=b.send_matrix(x))
    assert not rb["_cache_hit"]
    np.testing.assert_allclose(b.wrap(rb["G"]).to_numpy(), x.T @ x,
                               rtol=1e-4, atol=1e-4)


# =====================================================================
# transfer dedup
# =====================================================================
def test_dedup_upload_zero_modeled_bytes(ac, engine):
    x = RNG.randn(128, 32).astype(np.float32)
    a1 = ac.send_matrix(x)
    recs_before = len(engine.transfer_log.records)
    a2 = ac.send_matrix(x)
    rec = a2.last_transfer
    assert rec.dedup and rec.nbytes == 0 and rec.modeled_socket_s == 0.0
    assert rec.logical_nbytes == x.nbytes
    # the dedup crossing is logged distinctly, as a single record
    assert len(engine.transfer_log.records) == recs_before + 1
    assert engine.transfer_log.records[-1].dedup
    summ = engine.transfer_log.session_summary(ac.session)
    assert summ["dedup_uploads"] == 1
    assert summ["dedup_bytes_saved"] == x.nbytes
    # alias resolves to identical content under a distinct handle
    assert a2.handle.id != a1.handle.id
    np.testing.assert_array_equal(a2.to_numpy(), x)


def test_dedup_respects_free(ac, engine):
    x = RNG.randn(64, 8).astype(np.float32)
    a1 = ac.send_matrix(x)
    a1.free()                        # store reclaimed -> index dropped
    a2 = ac.send_matrix(x)
    assert not a2.last_transfer.dedup      # full stream again
    assert a2.last_transfer.nbytes == x.nbytes


def test_dedup_distinguishes_dtype_and_shape(ac):
    x = RNG.randn(32, 8).astype(np.float32)
    ac.send_matrix(x)
    assert not ac.send_matrix(x.astype(np.float64)).last_transfer.dedup
    assert not ac.send_matrix(x.reshape(8, 32)).last_transfer.dedup


def test_dedup_opt_out_streams(ac):
    x = RNG.randn(32, 8).astype(np.float32)
    ac.send_matrix(x)
    rec = ac.send_matrix(x, dedup=False).last_transfer
    assert not rec.dedup and rec.nbytes == x.nbytes


def test_dedup_aliases_are_copy_on_write(ac, engine):
    """Overwriting through one alias must not change the other's view."""
    x = np.ones((8, 4), np.float32)
    a1 = ac.send_matrix(x)
    a2 = ac.send_matrix(x)
    assert a2.last_transfer.dedup
    engine.overwrite(a2.handle, 5 * np.ones((8, 4), np.float32))
    np.testing.assert_array_equal(a1.to_numpy(), x)
    np.testing.assert_array_equal(a2.to_numpy(), 5 * x)


def test_rowmatrix_upload_dedups_against_array_upload(ac):
    """Content addressing is layout-independent client-side: the same
    bytes uploaded as ndarray then as a RowMatrix alias each other."""
    from repro_torch.frontend.rowmatrix import RowMatrix
    x = RNG.randn(60, 6)
    ac.send_matrix(x)
    rm = RowMatrix.from_array(x, num_partitions=4)
    assert ac.send_matrix(rm).last_transfer.dedup


def test_dedup_is_chunk_boundary_invariant(ac):
    """The fingerprint digests row-major bytes, not the chunk plan: the
    same matrix re-sent with a different chunk_rows still aliases."""
    x = RNG.randn(100, 8).astype(np.float32)
    ac.send_matrix(x, chunk_rows=33)
    assert ac.send_matrix(x, chunk_rows=7).last_transfer.dedup
    assert ac.send_matrix(x).last_transfer.dedup


def test_uncached_rdd_source_is_consumed_exactly_once(ac):
    """An uncached RDD lineage (bare map_rows) must not be re-iterated by
    the dedup hash pass: partitions compute once, the fingerprint is
    taken inline from the streamed bytes, and equal content uploaded
    later still dedups against it."""
    from repro_torch.frontend.rowmatrix import RowMatrix
    x = RNG.randn(40, 4)
    rm = RowMatrix.from_array(x, num_partitions=4)
    computes = []
    mapped = rm.map_rows(lambda p: computes.append(1) or (p * 2.0))
    assert not mapped.rdd.cached
    al = ac.send_matrix(mapped)
    # exactly one compute per partition: the width/dtype probe memoizes
    # the partition-0 realization it forced, and the stream reuses it
    assert len(computes) == 4
    assert not al.last_transfer.dedup        # no pre-stream lookup
    # the inline fingerprint matches what actually crossed: a cached
    # upload of the same bytes aliases against it
    assert ac.send_matrix(2.0 * x).last_transfer.dedup


def test_transfer_summary_does_not_count_dedup_as_chunk(ac, engine):
    x = RNG.randn(50, 4).astype(np.float32)
    ac.send_matrix(x, chunk_rows=10)         # 5 chunks
    ac.send_matrix(x, chunk_rows=10)         # dedup pseudo-record
    summ = engine.transfer_log.session_summary(ac.session)
    assert summ["to_engine_chunks"] == 5
    assert summ["dedup_uploads"] == 1


# =====================================================================
# cache lookups racing the scheduler's hazard edges
# =====================================================================
def test_hit_refused_while_writer_in_flight(engine):
    """Populate the cache, then submit a slow writer on the input and
    immediately a read of it: the read must NOT be served stale from the
    fast path — it queues behind the writer's hazard edge and recomputes
    on the new content."""
    def slow_scale(eng, A, factor=2.0, sleep=0.4):
        x = eng.get(A)
        time.sleep(sleep)
        eng.overwrite(A, x * factor)
        return {"A": A}
    slow_scale.writes = ("A",)

    def total(eng, A):
        return {"sum": float(np.asarray(eng.get(A)).sum())}

    class _Lib:
        ROUTINES = {"slow_scale": slow_scale, "total": total}

    engine.load_library("w", _Lib)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(np.ones((8, 2), np.float32))
    assert ac.call("w", "total", A=al)["sum"] == 16.0       # populates
    assert ac.call("w", "total", A=al)["_cache_hit"]        # sanity: hits
    fw = ac.call_async("w", "slow_scale", A=al, factor=3.0)
    fr = ac.call_async("w", "total", A=al)
    # submitted while the writer is QUEUED/RUNNING: must not be DONE with
    # the stale sum
    out = fr.result()
    assert out["sum"] == 48.0 and not out["_cache_hit"]
    fw.result()


def test_concurrent_identical_calls_race_safely(engine):
    """Many threads, two sessions, same computation: every result is
    correct and complete whether it was computed, raced, or served."""
    ctxs = [AlchemistContext(engine=engine) for _ in range(4)]
    x = RNG.randn(96, 24).astype(np.float32)
    als = [c.send_matrix(x) for c in ctxs]
    outs: list[dict] = [None] * 8
    errors: list[Exception] = []

    def work(i):
        try:
            c, al = ctxs[i % 4], als[i % 4]
            outs[i] = c.call("elemental", "truncated_svd", A=al, k=4)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    want = np.linalg.svd(x, compute_uv=False)[:4]
    for i, out in enumerate(outs):
        c = ctxs[i % 4]
        s = c.wrap(out["S"]).to_numpy().ravel()
        np.testing.assert_allclose(s, want, rtol=1e-3)
    # at least one hit happened across the identical workloads
    assert engine.cache_log.summary()["hits"] >= 1
    for c in ctxs:
        c.stop()
    assert engine.resident_bytes() == 0


# =====================================================================
# observability
# =====================================================================
def test_cache_log_per_session_accounting(engine):
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    x = RNG.randn(32, 8).astype(np.float32)
    a.call("elemental", "gram", A=a.send_matrix(x))
    b.call("elemental", "gram", A=b.send_matrix(x))
    sa = engine.cache_log.session_summary(a.session)
    sb = engine.cache_log.session_summary(b.session)
    assert sa["misses"] == 1 and sa["hits"] == 0
    assert sb["hits"] == 1 and sb["misses"] == 0
    assert sb["dedup_uploads"] == 1 and sb["bytes_saved"] == x.nbytes
    assert sb["saved_s"] > 0 and sb["hit_rate"] == 1.0
    assert engine.cache_log.sessions() == sorted([a.session, b.session])


def test_library_reregistration_invalidates_its_entries(engine):
    """Cache keys hash the library NAME, not its code: re-registering a
    library under the same name must drop its memoized results — both on
    the in-process path and ahead of the fast path when the reload is a
    still-queued wire barrier."""
    def probe_v1(eng, A):
        return {"version": 1}

    def probe_v2(eng, A):
        return {"version": 2}

    class _V1:
        ROUTINES = {"probe": probe_v1}

    class _V2:
        ROUTINES = {"probe": probe_v2}

    engine.load_library("mylib", _V1)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(RNG.randn(4, 2).astype(np.float32))
    assert ac.call("mylib", "probe", A=al)["version"] == 1
    assert ac.call("mylib", "probe", A=al)["_cache_hit"]     # memoized
    engine.load_library("mylib", _V2)
    out = ac.call("mylib", "probe", A=al)
    assert out["version"] == 2 and not out["_cache_hit"]
    # other libraries' entries survive a reload of mylib
    ac.call("elemental", "gram", A=al)
    engine.load_library("mylib", _V1)
    assert ac.call("elemental", "gram", A=al)["_cache_hit"]


def test_cache_disabled_engine_still_works():
    engine = AlchemistEngine(device="cpu", cache_entries=0)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
    r1 = ac.call("elemental", "gram", A=al)
    r2 = ac.call("elemental", "gram", A=al)
    assert not r1["_cache_hit"] and not r2["_cache_hit"]
    assert r1["G"].id != r2["G"].id
