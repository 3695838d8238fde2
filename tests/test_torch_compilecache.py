"""The port's compile cache (``repro_torch.core.compilecache`` and
``TorchBackend.get_or_compile``) under the tests of
``tests/test_compilecache.py``, test for test, on the CPU; then the same
inputs through both packages: ``pad_to``/``crop_to`` bit for bit, bucketed
results at 1e-5, index records; and the torch backend's small/large slot
rule.

Compile-latency subsystem (``core/compilecache.py``): bucket-policy
units, pad/crop conformance of every bucketable cataloged routine
against the reference backend at odd (non-bucket) shapes, shape-aware
plan signatures, the program-cache LRU bound, AOT warmup, the
persistent executable index + warm-restart zero-recompile round trip,
fused chains with bucketing on/off, CompileLog accounting, and the
``configure`` wire surface (bucketing/warmup/cache_dir options)."""
import threading

import numpy as np
import pytest

from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core import compilecache
from repro_torch.core.backends import base as backend_base
from repro_torch.core.backends.torch_backend import TorchBackend
from repro_torch.core.context import AlchemistError
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import elemental

RNG = np.random.RandomState(11)

# deliberately odd, off-grid shapes: every dimension pads under the
# default pow2 bucket grid
ODD_A = RNG.randn(37, 53).astype(np.float32)
ODD_B = RNG.randn(53, 29).astype(np.float32)
ODD_C = RNG.randn(37, 53).astype(np.float32)
ODD_SQ = (RNG.randn(19, 19) / 4.0).astype(np.float32)


def fresh(cache_entries=0, **engine_kw):
    engine = AlchemistEngine(device="cpu",
                             cache_entries=cache_entries, **engine_kw)
    engine.load_library("elemental", elemental)
    return engine


# ---------------------------------------------------------------------------
# BucketPolicy units
# ---------------------------------------------------------------------------
def test_bucket_dim_rounds_up_to_smallest_holding_bucket():
    p = compilecache.BucketPolicy(grid=(32, 64, 128))
    assert p.bucket_dim(1) == 32
    assert p.bucket_dim(32) == 32      # exact boundary stays
    assert p.bucket_dim(33) == 64
    assert p.bucket_dim(128) == 128
    assert p.bucket_dim(129) == 129    # beyond grid: passthrough


def test_bucket_shape_and_exactness():
    p = compilecache.BucketPolicy(grid=(32, 64))
    assert p.bucket_shape((37, 53)) == (64, 64)
    assert p.bucket_shape((32, 64)) == (32, 64)
    assert p.is_exact((32, 64))
    assert not p.is_exact((37, 53))


def test_disabled_policy_is_identity():
    p = compilecache.BucketPolicy(grid=(32, 64), enabled=False)
    assert p.bucket_dim(37) == 37
    assert p.bucket_shape((37, 53)) == (37, 53)
    assert p.is_exact((37, 53))


def test_bucket_grid_is_sorted_and_validated():
    p = compilecache.BucketPolicy(grid=(128, 32, 64))
    assert p.grid == (32, 64, 128)
    with pytest.raises(ValueError, match="positive"):
        compilecache.BucketPolicy(grid=(0, 32))


# ---------------------------------------------------------------------------
# pad/crop primitives
# ---------------------------------------------------------------------------
def test_pad_to_zero_pads_trailing_edges_and_crop_inverts():
    be = TorchBackend()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    padded = np.asarray(be.pad_to(a, (4, 8)))
    assert padded.shape == (4, 8)
    np.testing.assert_array_equal(padded[:2, :3], a)
    assert float(np.abs(padded[2:, :]).sum()) == 0.0
    assert float(np.abs(padded[:, 3:]).sum()) == 0.0
    back = np.asarray(be.crop_to(padded, (2, 3)))
    np.testing.assert_array_equal(back, a)


def test_pad_to_rejects_shrinking_targets():
    be = TorchBackend()
    a = np.zeros((4, 4), dtype=np.float32)
    with pytest.raises(ValueError):
        be.pad_to(a, (2, 8))
    with pytest.raises(ValueError):
        be.pad_to(a, (4, 4, 4))


# ---------------------------------------------------------------------------
# bucket-padding conformance: every bucketable cataloged routine,
# bucketed jax vs exact reference, at odd shapes
# ---------------------------------------------------------------------------
# per-routine odd-shape operand sets satisfying each routine's shape rule
BUCKETABLE_CASES = {
    ("elemental", "multiply"): {"A": ODD_A, "B": ODD_B},
    ("elemental", "add"): {"A": ODD_A, "B": ODD_C},
    ("elemental", "transpose"): {"A": ODD_A},
    ("elemental", "gram"): {"A": ODD_A},
}


def test_bucketable_catalog_is_fully_covered():
    """Every routine the jax backend declares bucketable has a
    conformance case here — a new bucketable registration must add one."""
    engine = fresh()
    try:
        be = engine.backends["torch"]
        declared = {(lib, rn) for lib, rn in be.routines()
                    if be.routine_impl(lib, rn).bucketable}
        assert declared == set(BUCKETABLE_CASES)
        # and the reference backend declares the identical bucketable set
        ref = engine.backends["reference"]
        assert declared == {(lib, rn) for lib, rn in ref.routines()
                            if ref.routine_impl(lib, rn).bucketable}
    finally:
        engine.shutdown()


@pytest.mark.parametrize("lib,rn", sorted(BUCKETABLE_CASES))
def test_bucketed_result_identical_to_reference(lib, rn):
    engine = fresh(bucketing=True)
    ac_jax = AlchemistContext(engine=engine)
    ac_ref = AlchemistContext(engine=engine, backend="reference")
    try:
        arrays = BUCKETABLE_CASES[(lib, rn)]
        outs = {}
        for ac in (ac_jax, ac_ref):
            handles = {k: ac.send_matrix(v, dedup=False)
                       for k, v in arrays.items()}
            res = ac.call(lib, rn, **handles)
            outs[ac] = {k: (ac.fetch(v).collect(),
                            tuple(v.shape), v.dtype, v.layout)
                        for k, v in res.items()
                        if isinstance(v, MatrixHandle)}
        assert set(outs[ac_jax]) == set(outs[ac_ref])
        for k in outs[ac_jax]:
            arr_j, shape_j, dtype_j, layout_j = outs[ac_jax][k]
            arr_r, shape_r, dtype_r, layout_r = outs[ac_ref][k]
            # padded program outputs are cropped back to logical shapes
            assert (shape_j, dtype_j, layout_j) == \
                (shape_r, dtype_r, layout_r)
            np.testing.assert_allclose(arr_j, arr_r, rtol=1e-4, atol=1e-4)
        # the jax run actually exercised the bucket path
        assert engine.compile_log.stats()["bucketed_executions"] >= 1
    finally:
        ac_jax.stop()
        ac_ref.stop()
        engine.shutdown()


def test_non_bucketable_routine_unaffected_by_bucketing():
    """qr's values depend on operand extents — it must run at its exact
    shape even with bucketing on, and still conform to reference."""
    engine = fresh(bucketing=True)
    ac_jax = AlchemistContext(engine=engine)
    ac_ref = AlchemistContext(engine=engine, backend="reference")
    try:
        assert not engine.backends["torch"].routine_impl(
            "elemental", "qr").bucketable
        outs = {}
        for ac in (ac_jax, ac_ref):
            h = ac.send_matrix(ODD_A, dedup=False)
            res = ac.call("elemental", "qr", A=h)
            outs[ac] = {k: ac.fetch(v).collect() for k, v in res.items()
                        if isinstance(v, MatrixHandle)}
        for k in outs[ac_jax]:
            assert outs[ac_jax][k].shape == outs[ac_ref][k].shape
        # Q@R reconstructs A on both
        for ac in (ac_jax, ac_ref):
            np.testing.assert_allclose(
                outs[ac]["Q"] @ outs[ac]["R"], ODD_A,
                rtol=1e-3, atol=1e-3)
    finally:
        ac_jax.stop()
        ac_ref.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# shape-aware plan signatures
# ---------------------------------------------------------------------------
def _plan(impl, shapes, dtype="float32"):
    args = {}
    specs = {}
    for n, (param, shape) in enumerate(sorted(shapes.items())):
        slot = f"i{n}"
        args[param] = backend_base.Input(slot)
        specs[slot] = (tuple(shape), dtype)
    return backend_base.ExecutionPlan(
        steps=[backend_base.PlanStep(library="elemental",
                                     routine="multiply", args=args,
                                     impl=impl)],
        input_specs=specs)


def test_signature_carries_operand_shapes_and_dtypes():
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    s1 = _plan(impl, {"A": (32, 32), "B": (32, 32)}).signature()
    s2 = _plan(impl, {"A": (64, 64), "B": (64, 64)}).signature()
    s3 = _plan(impl, {"A": (32, 32), "B": (32, 32)}).signature()
    s4 = _plan(impl, {"A": (32, 32), "B": (32, 32)},
               dtype="float64").signature()
    assert s1 != s2          # same structure, different shapes
    assert s1 == s3          # stable across rebuilds
    assert s1 != s4          # dtype is part of the identity
    hash(s1)                 # usable as a cache key


def test_signature_none_without_specs_is_distinct_key_shape():
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    plan = _plan(impl, {"A": (32, 32), "B": (32, 32)})
    plan.input_specs = None
    sig = plan.signature()
    assert sig is not None and sig[1] is None
    plan.steps[0].args["B"] = [1, 2]        # unhashable arg
    assert plan.signature() is None


# ---------------------------------------------------------------------------
# shape propagation (the crop-back contract)
# ---------------------------------------------------------------------------
def test_propagate_shapes_through_a_chain():
    be = TorchBackend()
    mul = be.routine_impl("elemental", "multiply")
    gram = be.routine_impl("elemental", "gram")
    plan = backend_base.ExecutionPlan(steps=[
        backend_base.PlanStep(
            library="elemental", routine="multiply",
            args={"A": backend_base.Input("i0"),
                  "B": backend_base.Input("i1")}, impl=mul),
        backend_base.PlanStep(
            library="elemental", routine="gram",
            args={"A": backend_base.StepRef(0, "C")}, impl=gram),
    ])
    crops = compilecache.propagate_shapes(
        plan, {"i0": (37, 53), "i1": (53, 29)})
    assert crops == [{"C": (37, 29)}, {"G": (29, 29)}]
    # a rule that rejects the shapes -> None, caller runs exact
    assert compilecache.propagate_shapes(
        plan, {"i0": (37, 53), "i1": (31, 29)}) is None
    assert compilecache.plan_bucketable(plan)


def test_plan_with_non_bucketable_step_is_not_bucketable():
    be = TorchBackend()
    mul = be.routine_impl("elemental", "multiply")
    qr = be.routine_impl("elemental", "qr")
    plan = backend_base.ExecutionPlan(steps=[
        backend_base.PlanStep(
            library="elemental", routine="multiply",
            args={"A": backend_base.Input("i0"),
                  "B": backend_base.Input("i1")}, impl=mul),
        backend_base.PlanStep(
            library="elemental", routine="qr",
            args={"A": backend_base.StepRef(0, "C")}, impl=qr),
    ])
    assert not compilecache.plan_bucketable(plan)


# ---------------------------------------------------------------------------
# warmup enumeration
# ---------------------------------------------------------------------------
def test_matrix_params_discovered_from_shape_rules():
    be = TorchBackend()
    assert compilecache.matrix_params_of(
        be.routine_impl("elemental", "multiply")) == ["A", "B"]
    assert compilecache.matrix_params_of(
        be.routine_impl("elemental", "gram")) == ["A"]
    assert compilecache.matrix_params_of(
        be.routine_impl("elemental", "qr")) == []


def test_warmup_shape_sets_respect_the_shape_rule():
    be = TorchBackend()
    mul = be.routine_impl("elemental", "multiply")
    combos = compilecache.warmup_shape_sets(mul, ["A", "B"], (32, 64),
                                            limit=1000)
    assert combos
    for c in combos:
        assert c["A"][1] == c["B"][0]       # contracted dims agree
    # 2 grid sizes: A has 4 shapes, B's rows pinned by A's cols -> 2 each
    assert len(combos) == 8
    add = be.routine_impl("elemental", "add")
    for c in compilecache.warmup_shape_sets(add, ["A", "B"], (32, 64),
                                            limit=1000):
        assert c["A"] == c["B"]
    # the enumeration ceiling holds
    assert len(compilecache.warmup_shape_sets(
        mul, ["A", "B"], (32, 64, 128, 256), limit=5)) == 5


# ---------------------------------------------------------------------------
# program-cache LRU bound
# ---------------------------------------------------------------------------
def test_program_cache_lru_evicts_oldest_and_counts():
    be = TorchBackend(max_programs=2)
    impl = be.routine_impl("elemental", "multiply")
    plans = [_plan(impl, {"A": (s, s), "B": (s, s)})
             for s in (8, 16, 32)]
    for p in plans:
        _, info = be.get_or_compile(p)
        assert not info["cached"]
    info = be.program_cache_info()
    assert info["programs"] == 2
    assert info["evictions"] == 1
    # oldest (8x8) was evicted -> recompiles; newest (32x32) still hot
    _, i32 = be.get_or_compile(plans[2])
    assert i32["cached"]
    _, i8 = be.get_or_compile(plans[0])
    assert not i8["cached"]
    assert be.evictions == 2                # recompile evicted 16x16


def test_aot_compiled_program_executes_without_retrace():
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    plan = _plan(impl, {"A": (8, 8), "B": (8, 8)})
    program, info = be.get_or_compile(plan)
    assert info["aot"] and not info["cached"] and info["compile_s"] > 0
    a = np.eye(8, dtype=np.float32)
    outs = program({"i0": a, "i1": a * 2.0})
    np.testing.assert_allclose(np.asarray(outs[0]["C"]), a * 2.0)


# ---------------------------------------------------------------------------
# executable index
# ---------------------------------------------------------------------------
def test_executable_index_round_trips_plans(tmp_path):
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    plan = _plan(impl, {"A": (32, 16), "B": (16, 8)})
    idx = compilecache.ExecutableIndex(str(tmp_path))
    assert idx.record("jax", plan, compile_s=0.5)
    assert not idx.record("jax", plan)       # re-record is a no-op
    assert len(idx) == 1
    # reload from disk and rebuild the plan against a live backend
    idx2 = compilecache.ExecutableIndex(str(tmp_path))
    [rec] = idx2.entries(backend="jax")
    assert rec["label"] == "elemental.multiply"
    rebuilt = compilecache.plan_from_record(rec, be)
    assert rebuilt is not None
    assert rebuilt.signature() == plan.signature()
    assert idx2.entries(backend="reference") == []


def test_executable_index_concurrent_engines_merge_not_clobber(tmp_path):
    """Two engines sharing a cache dir each loaded the index before the
    other recorded: without merge-on-write the second save clobbers the
    first engine's record (last-write-wins). Both must survive."""
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    plan_a = _plan(impl, {"A": (32, 16), "B": (16, 8)})
    plan_b = _plan(impl, {"A": (64, 32), "B": (32, 8)})
    idx1 = compilecache.ExecutableIndex(str(tmp_path))
    idx2 = compilecache.ExecutableIndex(str(tmp_path))  # both loaded empty
    assert idx1.record("jax", plan_a)
    assert idx2.record("jax", plan_b)   # must fold idx1's record in
    fresh = compilecache.ExecutableIndex(str(tmp_path))
    labels = sorted((r["key"] for r in fresh.entries()))
    assert len(fresh) == 2
    assert {r["key"] for r in idx1.entries()} <= set(labels)

    # threaded stress: interleaved writers through separate instances
    # never lose a record
    shapes = [( (16 * (i + 1), 8), (8, 4) ) for i in range(8)]
    plans = [_plan(impl, {"A": sa, "B": sb}) for sa, sb in shapes]
    writers = [compilecache.ExecutableIndex(str(tmp_path))
               for _ in range(2)]
    threads = [
        threading.Thread(target=lambda w=writers[i % 2], p=p:
                         w.record("jax", p))
        for i, p in enumerate(plans)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compilecache.ExecutableIndex(str(tmp_path))) == 2 + len(plans)


def test_executable_index_skips_unserializable_plans(tmp_path):
    be = TorchBackend()
    impl = be.routine_impl("elemental", "multiply")
    plan = _plan(impl, {"A": (8, 8), "B": (8, 8)})
    plan.input_specs = None                  # shape-blind: not replayable
    idx = compilecache.ExecutableIndex(str(tmp_path))
    assert not idx.record("jax", plan)
    assert len(idx) == 0


# ---------------------------------------------------------------------------
# CompileLog accounting
# ---------------------------------------------------------------------------
def test_compile_log_separates_request_from_warmup():
    from repro_torch.core.costmodel import CompileLog

    log = CompileLog()
    log.record(1, "elemental.multiply", "compile", aot=True,
               bucketed=True, compile_s=0.5)
    log.record(-1, "elemental.gram", "compile", aot=True,
               on_request_path=False, compile_s=0.2)
    log.record(1, "elemental.multiply", "hit", bucketed=True)
    log.record(1, "elemental.multiply", "evict", count=2)
    s = log.stats()
    assert s["compiles"] == 2
    assert s["hits"] == 1
    assert s["request_compiles"] == 1
    assert s["warmup_compiles"] == 1
    assert s["request_compile_s"] == pytest.approx(0.5)
    assert s["warmup_compile_s"] == pytest.approx(0.2)
    assert s["bucketed_executions"] == 2
    assert s["bucketed_request_compiles"] == 1
    assert s["evictions"] == 2
    assert s["hit_rate"] == pytest.approx(1 / 3)
    per = log.session_summary(1)
    assert per["compiles"] == 1 and per["warmup_compiles"] == 0
    assert set(log.sessions()) == {1, -1}


# ---------------------------------------------------------------------------
# engine warmup: catalog AOT off the request path
# ---------------------------------------------------------------------------
def test_warmup_precompiles_catalog_and_absorbs_first_calls():
    # engine bucket grid == warmup grid: every odd dim pads to 64, so
    # the warmed 64-combos absorb ALL first calls (a warmup grid
    # narrower than the bucket grid only absorbs its own buckets)
    engine = fresh(bucketing=True, bucket_grid=(64,))
    ac = AlchemistContext(engine=engine)
    try:
        stats = engine.warmup(grid=(64,))
        assert stats["catalog"] >= len(BUCKETABLE_CASES)
        assert stats["compiled"] >= len(BUCKETABLE_CASES)
        log0 = engine.compile_log.stats()
        assert log0["warmup_compiles"] == stats["compiled"]
        assert log0["request_compiles"] == 0
        # first tenant calls at odd shapes bucketing to 64: all absorbed
        ha = ac.send_matrix(ODD_A, dedup=False)
        hb = ac.send_matrix(ODD_B, dedup=False)
        ac.call("elemental", "multiply", A=ha, B=hb)
        ac.call("elemental", "gram", A=ha)
        ac.call("elemental", "transpose", A=ha)
        log = engine.compile_log.stats()
        assert log["request_compiles"] == 0, log
        assert log["bucketed_request_compiles"] == 0
        assert log["hits"] >= 3
    finally:
        ac.stop()
        engine.shutdown()


def test_warmup_on_load_runs_in_background():
    engine = AlchemistEngine(device="cpu", cache_entries=0,
                             warmup_on_load=True, warmup_grid=(32,))
    try:
        engine.load_library("elemental", elemental)
        engine.wait_warmup()
        s = engine.compile_log.stats()
        assert s["warmup_compiles"] >= len(BUCKETABLE_CASES)
        assert s["request_compiles"] == 0
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------------
# persistence: warm-restart zero-recompile round trip
# ---------------------------------------------------------------------------
def test_warm_restart_replays_index_and_absorbs_requests(tmp_path):
    cache_dir = str(tmp_path / "ccache")

    def serve_one(eng):
        ac = AlchemistContext(engine=eng)
        try:
            ha = ac.send_matrix(ODD_A, dedup=False)
            hb = ac.send_matrix(ODD_B, dedup=False)
            res = ac.call("elemental", "multiply", A=ha, B=hb)
            return ac.fetch(res["C"]).collect()
        finally:
            ac.stop()

    # cold engine: the request-path compile lands in the index
    eng1 = fresh(compile_cache_dir=cache_dir, bucketing=True)
    try:
        out1 = serve_one(eng1)
        assert eng1.compile_log.stats()["request_compiles"] == 1
        assert len(eng1._exec_index) >= 1
    finally:
        eng1.shutdown()

    # restarted engine, same dir: warmup replays the index; the same
    # tenant traffic then sees ZERO request-path compiles
    eng2 = fresh(compile_cache_dir=cache_dir, bucketing=True)
    try:
        stats = eng2.warmup()
        assert stats["replayed"] >= 1
        out2 = serve_one(eng2)
        log = eng2.compile_log.stats()
        assert log["request_compiles"] == 0, log
        assert log["hits"] >= 1
        np.testing.assert_allclose(out2, out1, rtol=1e-5)
    finally:
        eng2.shutdown()


# ---------------------------------------------------------------------------
# fused chains: results unchanged bucketing on/off
# ---------------------------------------------------------------------------
def _burst_chain(ac, stages=3):
    el = ac.library("elemental")
    al = ac.send_matrix(ODD_SQ, dedup=False)
    ac.engine.scheduler.pause()
    x = al
    for _ in range(stages):
        x = el.multiply(A=x, B=al)
    ac.engine.scheduler.resume()
    return x.to_numpy()


def _settled_task_stats(engine, commands, timeout=5.0):
    """Task-log records land via the scheduler completion hook, slightly
    after the client sees the result — poll until every command's record
    arrived before asserting on the accounting."""
    import time as _time

    deadline = _time.monotonic() + timeout
    while _time.monotonic() < deadline:
        s = engine.task_log.stats()
        if s["commands"] >= commands:
            return s
        _time.sleep(0.01)
    return engine.task_log.stats()


@pytest.mark.parametrize("bucketing", [True, False])
def test_fused_chain_results_unchanged_by_bucketing(bucketing):
    engine = fresh(bucketing=bucketing)
    ac = AlchemistContext(engine=engine)
    try:
        got = _burst_chain(ac)
        want = ODD_SQ
        for _ in range(3):
            want = want @ ODD_SQ
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        stats = _settled_task_stats(engine, commands=3)
        assert stats["fused_tasks"] >= 1, stats   # the chain really fused
        log = engine.compile_log.stats()
        if bucketing:
            assert log["bucketed_executions"] >= 1
        else:
            assert log["bucketed_executions"] == 0
    finally:
        ac.stop()
        engine.shutdown()


def test_session_bucketing_override_vs_engine_default():
    engine = fresh(bucketing=True)
    ac_off = AlchemistContext(engine=engine, bucketing=False)
    ac_on = AlchemistContext(engine=engine)
    try:
        ha = ac_off.send_matrix(ODD_A, dedup=False)
        ac_off.call("elemental", "gram", A=ha)
        assert engine.compile_log.stats()["bucketed_executions"] == 0
        hb = ac_on.send_matrix(ODD_A, dedup=False)
        ac_on.call("elemental", "gram", A=hb)
        assert engine.compile_log.stats()["bucketed_executions"] == 1
    finally:
        ac_off.stop()
        ac_on.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# configure wire surface
# ---------------------------------------------------------------------------
def test_configure_echoes_bucketing_and_cache_dir(tmp_path):
    engine = fresh()
    ac = AlchemistContext(engine=engine)
    try:
        eff = ac.configure(bucketing=False)
        assert eff["bucketing"] is False
        eff = ac.configure(bucketing=True)
        assert eff["bucketing"] is True
        cache_dir = str(tmp_path / "cc")
        eff = ac.configure(cache_dir=cache_dir)
        assert eff["cache_dir"] == cache_dir
        assert engine.compile_cache_dir == cache_dir
    finally:
        ac.stop()
        engine.shutdown()


def test_configure_warmup_over_the_wire_returns_counts():
    engine = fresh()
    ac = AlchemistContext(engine=engine)
    try:
        eff = ac.configure(warmup=[32])
        w = eff["warmup"]
        assert w["backend"] == "torch"
        assert w["catalog"] >= len(BUCKETABLE_CASES)
        assert engine.compile_log.stats()["request_compiles"] == 0
    finally:
        ac.stop()
        engine.shutdown()


def test_configure_rejects_bad_options_without_mutating():
    engine = fresh()
    ac = AlchemistContext(engine=engine)
    try:
        with pytest.raises(AlchemistError, match="bucketing"):
            ac.configure(bucketing="yes")
        with pytest.raises(AlchemistError, match="warmup"):
            ac.configure(warmup=[0])
        with pytest.raises(AlchemistError, match="warmup"):
            ac.configure(warmup="now")
        with pytest.raises(AlchemistError, match="cache_dir"):
            ac.configure(cache_dir=7)
        sess = engine.session(ac.session)
        assert sess.bucketing is None        # nothing half-applied
        assert engine.compile_cache_dir is None
    finally:
        ac.stop()
        engine.shutdown()


def test_compile_stats_builtin_over_the_wire():
    engine = fresh(bucketing=True)
    ac = AlchemistContext(engine=engine)
    try:
        ha = ac.send_matrix(ODD_A, dedup=False)
        ac.call("elemental", "gram", A=ha)
        stats = ac.call("_engine", "compile_stats")
        assert stats["session"]["session"] == ac.session
        assert stats["session"]["compiles"] == 1
        assert stats["engine"]["bucketed_executions"] == 1
        assert "program_caches" in stats["engine"]
    finally:
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# the same inputs through both packages
# ---------------------------------------------------------------------------
import torch  # noqa: E402

from repro.core import AlchemistContext as RefContext  # noqa: E402
from repro.core import AlchemistEngine as RefEngine  # noqa: E402
from repro.core import compilecache as ref_compilecache  # noqa: E402
from repro.core.backends import base as ref_base  # noqa: E402
from repro.core.backends.jax_backend import JaxBackend  # noqa: E402
from repro.core.engine import make_engine_mesh  # noqa: E402
from repro.core.libraries import elemental as ref_elemental  # noqa: E402
from repro_torch.core.backends import torch_backend  # noqa: E402

PAD_CASES = [
    (np.arange(6, dtype=np.float32).reshape(2, 3), (4, 8)),
    (ODD_A, (64, 64)),
    (ODD_A, (37, 64)),                          # one dimension only
    (ODD_B, (53, 29)),                          # exact: nothing to pad
    (np.arange(5, dtype=np.int32), (9,)),
    (RNG.randn(3, 4, 5).astype(np.float32), (4, 4, 8)),
]


@pytest.mark.parametrize("array,shape", PAD_CASES,
                         ids=[f"{a.shape}->{s}" for a, s in PAD_CASES])
def test_pad_and_crop_equal_the_jax_backends_bit_for_bit(array, shape):
    port, ref = TorchBackend(), JaxBackend()
    got = np.asarray(port.pad_to(array, shape))
    want = np.asarray(ref.pad_to(array, shape))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    back = np.asarray(port.crop_to(torch.from_numpy(got), array.shape))
    want_back = np.asarray(ref.crop_to(ref.pad_to(array, shape),
                                       array.shape))
    assert back.tobytes() == want_back.tobytes() == array.tobytes()
    for bad in ((2, 8), (4, 4, 4, 4)):
        for be in (port, ref):
            with pytest.raises(ValueError, match="cannot pad"):
                be.pad_to(np.zeros((4, 4), np.float32), bad)


@pytest.mark.parametrize("lib,rn", sorted(BUCKETABLE_CASES))
def test_bucketed_results_equal_the_jax_packages(lib, rn):
    """The port's bucketed routine at odd shapes against the JAX
    package's bucketed routine on the same arrays, at 1e-5."""
    arrays = BUCKETABLE_CASES[(lib, rn)]
    outs = {}
    for name, eng_cls, ctx_cls, lib_mod, kw in (
            ("port", AlchemistEngine, AlchemistContext, elemental,
             {"device": "cpu"}),
            ("ref", RefEngine, RefContext, ref_elemental,
             {"mesh": make_engine_mesh(1)})):
        engine = eng_cls(cache_entries=0, bucketing=True, **kw)
        engine.load_library("elemental", lib_mod)
        ac = ctx_cls(engine=engine)
        try:
            handles = {k: ac.send_matrix(v, dedup=False)
                       for k, v in arrays.items()}
            res = ac.call(lib, rn, **handles)
            outs[name] = {k: ac.fetch(v).collect() for k, v in res.items()
                          if hasattr(v, "shape")}
            assert engine.compile_log.stats()["bucketed_executions"] == 1
        finally:
            ac.stop()
            engine.shutdown()
    assert set(outs["port"]) == set(outs["ref"])
    for k, want in outs["ref"].items():
        got = outs["port"][k]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def _both_plans(shapes):
    """One multiply-then-gram plan with the same args and specs, built
    from each package's own implementations."""
    plans = []
    for bb, be in ((backend_base, TorchBackend()),
                   (ref_base, JaxBackend())):
        plans.append(bb.ExecutionPlan(steps=[
            bb.PlanStep(library="elemental", routine="multiply",
                        args={"A": bb.Input("i0"), "B": bb.Input("i1")},
                        impl=be.routine_impl("elemental", "multiply")),
            bb.PlanStep(library="elemental", routine="gram",
                        args={"A": bb.StepRef(0, "C"), "use_pallas": False},
                        impl=be.routine_impl("elemental", "gram"))],
            input_specs={s: (shape, "float32")
                         for s, shape in shapes.items()}))
    return plans


def test_plan_records_equal_the_jax_packages_but_for_the_backend(tmp_path):
    port_plan, ref_plan = _both_plans({"i0": (64, 64), "i1": (64, 32)})
    rec = compilecache.plan_record("torch", port_plan, 0.25)
    want = ref_compilecache.plan_record("jax", ref_plan, 0.25)
    assert rec["key"] == compilecache.signature_key(
        "torch", port_plan.signature())
    assert {**rec, "backend": "jax",
            "key": ref_compilecache.signature_key(
                "jax", ref_plan.signature())} == want
    # and what each engine records for the same request
    recs = {}
    for name, eng_cls, ctx_cls, lib_mod, kw in (
            ("port", AlchemistEngine, AlchemistContext, elemental,
             {"device": "cpu"}),
            ("ref", RefEngine, RefContext, ref_elemental,
             {"mesh": make_engine_mesh(1)})):
        engine = eng_cls(cache_entries=0, bucketing=True,
                         compile_cache_dir=str(tmp_path / name), **kw)
        engine.load_library("elemental", lib_mod)
        ac = ctx_cls(engine=engine)
        try:
            ac.call("elemental", "multiply",
                    A=ac.send_matrix(ODD_A, dedup=False),
                    B=ac.send_matrix(ODD_B, dedup=False))
            [r] = engine._exec_index.entries()
            recs[name] = {k: v for k, v in r.items()
                          if k not in ("key", "backend", "compile_s")}
        finally:
            ac.stop()
            engine.shutdown()
    assert recs["port"] == recs["ref"]
    assert recs["port"]["input_specs"] == {"i0": [[64, 64], "float32"],
                                           "i1": [[64, 32], "float32"]}


def test_get_or_compile_reports_the_jax_backends_keys():
    port_plan, ref_plan = _both_plans({"i0": (8, 8), "i1": (8, 8)})
    port, ref = TorchBackend(), JaxBackend()
    for _ in range(2):
        got, want = port.get_or_compile(port_plan)[1], \
            ref.get_or_compile(ref_plan)[1]
        assert set(got) == set(want) == {"cached", "compile_s", "aot",
                                         "evicted"}
        assert (got["cached"], got["aot"]) == (want["cached"], want["aot"])
    # the port also reports the device bytes its programs hold and their
    # bound (a static program pins buffers; a JAX executable pins none)
    assert set(port.program_cache_info()) == \
        set(ref.program_cache_info()) | {"held_bytes", "max_program_bytes"}


# ---------------------------------------------------------------------------
# the torch backend's slots: small ones are copied or run on zeros at
# compile time, large ones are read in place
# ---------------------------------------------------------------------------
EDGE = max(compilecache.DEFAULT_BUCKET_GRID)


def _gram_plan(be, specs):
    return backend_base.ExecutionPlan(
        steps=[backend_base.PlanStep(
            library="elemental", routine="gram",
            args={"A": backend_base.Input(slot)},
            impl=be.routine_impl("elemental", "gram"))
            for slot in specs],
        input_specs=specs)


@pytest.fixture()
def no_allocation(monkeypatch):
    """Any tensor made at compile time fails the test."""
    def refuse(*a, **k):
        raise AssertionError("allocated at compile time")
    monkeypatch.setattr(torch, "zeros", refuse)


@pytest.mark.parametrize("shape,dtype,small", [
    ((EDGE, EDGE), "float32", True),            # 256 MiB: the edge
    ((EDGE, EDGE + 1), "float32", False),
    ((EDGE + 1, EDGE), "float32", False),
    ((EDGE, 2 * EDGE), "bfloat16", True),
    ((EDGE, EDGE), "float64", False),
    ((2 * EDGE * EDGE,), "int16", True),
])
def test_the_slot_rule_at_the_256_mib_edge(shape, dtype, small,
                                           no_allocation):
    assert compilecache.SMALL_SLOT_BYTES == EDGE * EDGE * 4 == 2 ** 28
    be = TorchBackend()
    assert torch_backend.small_slots(
        _gram_plan(be, {"i0": (shape, dtype)})) is small
    # a plan is small only when every slot is
    assert torch_backend.small_slots(_gram_plan(
        be, {"i0": ((8, 8), "float32"), "i1": (shape, dtype)})) is small
    if not small:
        # built from specs without touching memory: nothing to run on
        program, info = be.get_or_compile(
            _gram_plan(be, {"i0": (shape, dtype)}))
        assert info["aot"] and not info["cached"]
        assert program.nbytes == 0


def test_specless_plans_are_never_small():
    be = TorchBackend()
    plan = _gram_plan(be, {"i0": ((8, 8), "float32")})
    plan.input_specs = None
    assert not torch_backend.small_slots(plan)
    program, info = be.get_or_compile(plan)
    assert not info["aot"]


def test_a_large_slot_chain_for_a_card_keeps_address_captures(
        no_allocation):
    """On a card a capturable chain with a large slot is built without a
    tensor (nothing to capture yet, ``aot`` false); its captures are keyed
    by input address when it runs. Decided from the specs alone, so it is
    checked here without a card; CPU inputs then run eagerly."""
    be = TorchBackend()
    be.device = torch.device("cuda")
    mul = be.routine_impl("elemental", "multiply")
    plan = backend_base.ExecutionPlan(steps=[
        backend_base.PlanStep(library="elemental", routine="multiply",
                              args={"A": backend_base.Input("i0"),
                                    "B": backend_base.Input("i1")},
                              impl=mul),
        backend_base.PlanStep(library="elemental", routine="transpose",
                              args={"A": backend_base.StepRef(0, "C")},
                              impl=be.routine_impl("elemental",
                                                   "transpose"))],
        input_specs={"i0": ((EDGE, EDGE + 1), "float32"),
                     "i1": ((EDGE + 1, 8), "float32")})
    assert be.capturable(plan)
    program, info = be.get_or_compile(plan)
    assert isinstance(program, torch_backend._ByAddress)
    assert not info["aot"] and not info["cached"]
    assert be.graphs() == 0 and be.held_bytes() == 0
    a, b = torch.ones(3, 4), torch.ones(4, 2)
    outs = program({"i0": a, "i1": b})
    assert torch.equal(outs[1]["C"], (a @ b).T)
    assert be.get_or_compile(plan)[1]["cached"]


def test_an_eager_program_holds_no_buffers():
    """Single ops, plans that refuse capture and every plan on the CPU are
    eager programs: run once on zeros at their spec's shapes when built,
    then on the caller's tensors, holding nothing between calls."""
    be = TorchBackend()
    runs = []
    real = torch_backend._interpret

    def counting(plan, inputs):
        runs.append({k: tuple(v.shape) for k, v in inputs.items()})
        return real(plan, inputs)

    mul = be.routine_impl("elemental", "multiply")
    qr = be.routine_impl("elemental", "qr")
    single = _plan(mul, {"A": (16, 8), "B": (8, 4)})
    host = backend_base.ExecutionPlan(steps=[
        backend_base.PlanStep(library="elemental", routine="qr",
                              args={"A": backend_base.Input("i0")},
                              impl=qr),
        backend_base.PlanStep(library="elemental", routine="multiply",
                              args={"A": backend_base.StepRef(0, "Q"),
                                    "B": backend_base.StepRef(0, "R")},
                              impl=mul)],
        input_specs={"i0": ((16, 8), "float32")})
    chain = backend_base.ExecutionPlan(steps=[
        backend_base.PlanStep(library="elemental", routine="multiply",
                              args={"A": backend_base.Input("i0"),
                                    "B": backend_base.Input("i0")},
                              impl=mul),
        backend_base.PlanStep(library="elemental", routine="add",
                              args={"A": backend_base.StepRef(0, "C"),
                                    "B": backend_base.Input("i0")},
                              impl=be.routine_impl("elemental", "add"))],
        input_specs={"i0": ((8, 8), "float32")})
    assert be.capturable(chain)          # but this backend is on the CPU
    try:
        torch_backend._interpret = counting
        for plan, shapes in ((single, {"i0": (16, 8), "i1": (8, 4)}),
                             (host, {"i0": (16, 8)}),
                             (chain, {"i0": (8, 8)})):
            runs.clear()
            program, info = be.get_or_compile(plan)
            assert info["aot"] and not info["cached"]
            assert runs == [shapes]              # once, on zeros
            assert program.graph is None and program.nbytes == 0
            assert be.get_or_compile(plan)[1]["cached"]
            assert len(runs) == 1                # a hit runs nothing
    finally:
        torch_backend._interpret = real
    x = torch.from_numpy(RNG.randn(16, 8).astype(np.float32))
    q_r = be.get_or_compile(host)[0]({"i0": x})[1]["C"]
    np.testing.assert_allclose(q_r.numpy(), x.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert be.graphs() == 0 and be.held_bytes() == 0
    assert be.program_cache_info()["programs"] == 3


def test_concurrent_get_or_compile_builds_each_signature_once():
    """Workers and the background warmup share one program cache: under
    many threads and a short switch interval each signature is built
    once, every caller gets the program that was kept, and the LRU's
    count and evictions agree with what was built."""
    import sys

    be = TorchBackend(max_programs=6)
    mul = be.routine_impl("elemental", "multiply")
    plans = [_plan(mul, {"A": (s, s), "B": (s, s)})
             for s in range(2, 10)]                  # 8 signatures
    built, real = [], be._run_on_zeros
    be._run_on_zeros = lambda plan: (built.append(plan.signature()),
                                     real(plan))
    got, errors = [], []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for i in rng.permutation(len(plans))[:6]:
                program, info = be.get_or_compile(plans[i])
                got.append((i, program, info["cached"]))
        except Exception as e:                       # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 16 * 6
    fresh = [i for i, _, cached in got if not cached]
    # each build is one fresh answer; a signature is built again only
    # after the LRU dropped it
    assert len(built) == len(fresh) >= len(set(fresh))
    info = be.program_cache_info()
    assert info["programs"] == 6
    assert info["evictions"] == len(built) - 6
