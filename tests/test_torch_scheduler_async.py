"""The port's async scheduler (``repro_torch.core.scheduler``, ``engine``)
under the tests of ``tests/test_scheduler_async.py``, test for test, over
both bridges, with chain fusion on.

Async task-scheduler tests: the task table and its dependency edges
(program order, read/write hazards, barriers, data deps), the
submit/poll/wait wire surface, deferred-handle chaining, the wire path of
register_library, and a multi-threaded multi-session stress test proving
concurrency is real while isolation and ordering hold."""
import threading
import time

import msgpack
import numpy as np
import pytest

from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core import protocol
from repro_torch.core.context import AlchemistError
from repro_torch.core.engine import ENGINE_LIBRARY
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import elemental
from repro_torch.core.scheduler import (
    DONE, FAILED, QUEUED, RUNNING, TaskFailure, TaskScheduler)
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(0)


@pytest.fixture()
def engine():
    return AlchemistEngine(device="cpu", scheduler_workers=4)


# =====================================================================
# scheduler unit level (engine-agnostic task table)
# =====================================================================
def test_single_task_lifecycle_and_timing():
    sched = TaskScheduler(num_workers=2)
    task = sched.submit(lambda t: 42, session=1, label="answer")
    done = sched.wait(task.id, timeout=10)
    assert done.state == DONE and done.result == 42
    assert done.wait_s >= 0 and done.exec_s >= 0
    assert sched.counts()[DONE] == 1


def test_failed_task_records_error_and_payload():
    sched = TaskScheduler(num_workers=1)
    t1 = sched.submit(lambda t: 1 / 0, session=1)
    t2 = sched.submit(
        lambda t: (_ for _ in ()).throw(TaskFailure(b"payload", "nope")),
        session=1)
    assert sched.wait(t1.id, timeout=10).state == FAILED
    assert "ZeroDivisionError" in sched.task(t1.id).error
    done2 = sched.wait(t2.id, timeout=10)
    assert done2.state == FAILED and done2.result == b"payload"


def test_sessions_overlap_but_program_order_is_serial():
    """Two sessions' tasks run concurrently; one session's never do."""
    sched = TaskScheduler(num_workers=4)
    order = []
    lock = threading.Lock()

    def body(tag, sleep):
        def fn(task):
            time.sleep(sleep)
            with lock:
                order.append(tag)
        return fn

    # session 1: first task sleeps longer than the second — with any
    # intra-session overlap the order would invert
    a1 = sched.submit(body("a1", 0.25), session=1)
    a2 = sched.submit(body("a2", 0.0), session=1)
    b1 = sched.submit(body("b1", 0.25), session=2)
    b2 = sched.submit(body("b2", 0.0), session=2)
    for t in (a1, a2, b1, b2):
        sched.wait(t.id, timeout=30)
    assert order.index("a1") < order.index("a2")
    assert order.index("b1") < order.index("b2")
    assert sched.max_running_observed >= 2     # cross-session overlap


def test_concurrent_readers_overlap_writer_excludes():
    """Hazards on one handle: readers of H run together; a writer of H
    waits for all prior readers and blocks later readers."""
    sched = TaskScheduler(num_workers=4)
    H = 77
    events = []
    lock = threading.Lock()

    def reader(tag):
        def fn(task):
            with lock:
                events.append((tag, "start"))
            time.sleep(0.2)
            with lock:
                events.append((tag, "end"))
        return fn

    # distinct sessions so program order contributes no edges
    r1 = sched.submit(reader("r1"), session=1, reads=[H])
    r2 = sched.submit(reader("r2"), session=2, reads=[H])
    w = sched.submit(reader("w"), session=3, writes=[H])
    r3 = sched.submit(reader("r3"), session=4, reads=[H])
    for t in (r1, r2, w, r3):
        sched.wait(t.id, timeout=30)

    def idx(tag, kind):
        return events.index((tag, kind))

    # both readers started before either ended => they overlapped
    assert max(idx("r1", "start"), idx("r2", "start")) < \
        min(idx("r1", "end"), idx("r2", "end"))
    # writer strictly after both readers finished
    assert idx("w", "start") > max(idx("r1", "end"), idx("r2", "end"))
    # reader after the write strictly after the writer finished
    assert idx("r3", "start") > idx("w", "end")


def test_write_write_hazard_orders_writers():
    sched = TaskScheduler(num_workers=4)
    H = 5
    seen = []
    w1 = sched.submit(lambda t: (time.sleep(0.2), seen.append("w1")),
                      session=1, writes=[H])
    w2 = sched.submit(lambda t: seen.append("w2"), session=2, writes=[H])
    sched.wait(w1.id, timeout=30)
    sched.wait(w2.id, timeout=30)
    assert seen == ["w1", "w2"]


def test_barrier_waits_for_all_and_blocks_later():
    sched = TaskScheduler(num_workers=4)
    events = []
    lock = threading.Lock()

    def mark(tag, sleep=0.0):
        def fn(task):
            time.sleep(sleep)
            with lock:
                events.append(tag)
        return fn

    t1 = sched.submit(mark("t1", 0.2), session=1)
    t2 = sched.submit(mark("t2", 0.2), session=2)
    bar = sched.submit(mark("bar"), session=3, barrier=True)
    t3 = sched.submit(mark("t3"), session=4)
    for t in (t1, t2, bar, t3):
        sched.wait(t.id, timeout=30)
    assert events.index("bar") > max(events.index("t1"), events.index("t2"))
    assert events.index("t3") > events.index("bar")


def test_failure_propagates_only_through_data_deps():
    sched = TaskScheduler(num_workers=2)
    bad = sched.submit(lambda t: 1 / 0, session=1)
    # same-session successor (program-order edge only): must still run
    ok = sched.submit(lambda t: "fine", session=1)
    # data-dependent consumer (any session): must fail without running
    ran = []
    consumer = sched.submit(lambda t: ran.append(1), session=2,
                            data_deps=[bad.id])
    assert sched.wait(ok.id, timeout=30).result == "fine"
    got = sched.wait(consumer.id, timeout=30)
    assert got.state == FAILED and "upstream task" in got.error
    assert not ran
    # a data dep that already failed before submission also propagates
    late = sched.submit(lambda t: ran.append(2), session=3,
                        data_deps=[bad.id])
    assert sched.wait(late.id, timeout=30).state == FAILED
    assert not ran


def test_scheduler_wait_timeout_and_unknown_task():
    sched = TaskScheduler(num_workers=1)
    t = sched.submit(lambda task: time.sleep(0.5), session=1)
    with pytest.raises(TimeoutError):
        sched.wait(t.id, timeout=0.01)
    with pytest.raises(KeyError):
        sched.wait(98765)
    sched.wait(t.id, timeout=30)


# =====================================================================
# protocol: submit/poll/wait wire surface
# =====================================================================
def test_task_op_roundtrip_and_bad_action():
    op = protocol.TaskOp(action=protocol.WAIT, task=9, session=3)
    assert protocol.decode_task_op(protocol.encode_task_op(op)) == op
    with pytest.raises(ValueError):
        protocol.encode_task_op(protocol.TaskOp(action="cancel", task=1))


def test_task_op_wire_requires_session_field():
    with pytest.raises(KeyError):
        protocol.decode_task_op(msgpack.packb({"action": "poll", "task": 1}))


def test_deferred_handle_roundtrips_inside_command():
    d = protocol.DeferredHandle(task=4, key="Q")
    cmd = protocol.Command("lib", "fn", {"A": d, "nest": [d, 1]}, session=2)
    back = protocol.decode_command(protocol.encode_command(cmd))
    assert back.args["A"] == d and back.args["nest"][0] == d


def test_result_roundtrips_task_and_timing_fields():
    res = protocol.Result(values={}, error="", session=2, task=11,
                          state="DONE", wait_s=0.5, exec_s=1.5)
    back = protocol.decode_result(protocol.encode_result(res))
    assert back == res


def test_result_decode_tolerates_pre_scheduler_wire_bytes():
    old = msgpack.packb({"values": {}, "elapsed": 0.1, "error": "",
                        "session": 4})
    res = protocol.decode_result(old)
    assert res.task == 0 and res.state == "" and res.wait_s == 0.0


# =====================================================================
# engine + context: async calls, futures, chaining
# =====================================================================
def test_call_async_returns_future_then_result(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    fut = ac.call_async("elemental", "random_matrix", rows=16, cols=4)
    out = fut.result()
    assert out["A"].shape == (16, 4)
    assert fut.done() and fut.state() == "DONE"
    assert out["_exec_s"] > 0 and out["_wait_s"] >= 0
    # a completed future resolves its outputs to real handles
    assert isinstance(fut["A"], MatrixHandle)


def test_deferred_chain_pipelines_engine_side(engine):
    """Submit a 3-deep chain in one burst; handles resolve engine-side."""
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.2: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    ac.call_async("slow", "nap")             # pins the session's queue
    f1 = ac.call_async("elemental", "random_matrix", rows=24, cols=6,
                       seed=5)
    f2 = ac.call_async("elemental", "gram", A=f1["A"])
    f3 = ac.call_async("elemental", "multiply", A=f1["A"], B=f2["G"])
    # while the producer is still queued, outputs are placeholders
    assert isinstance(f1["A"], protocol.DeferredHandle)
    got = ac.wrap(f3.result()["C"]).to_numpy()
    a = ac.wrap(f1["A"]).to_numpy()          # real handle once finished
    np.testing.assert_allclose(got, a @ (a.T @ a), rtol=1e-4, atol=1e-5)


def test_poll_observes_nonterminal_then_terminal_state(engine):
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.3: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    ac = AlchemistContext(engine=engine)
    fut = ac.call_async("slow", "nap")
    assert fut.state() in (QUEUED, RUNNING, DONE)
    assert fut.result()["ok"] == 1
    assert fut.state() == DONE


def test_failed_routine_surfaces_via_future_and_poisons_only_dependents(
        engine):
    def boom(eng, s=0.3):
        time.sleep(s)
        raise RuntimeError("boom")

    class _Bad:
        ROUTINES = {"boom": boom}

    engine.load_library("badlib", _Bad)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    bad = ac.call_async("badlib", "boom")
    # submitted while the producer is still in flight -> deferred edge
    dependent = ac.call_async("elemental", "multiply", A=bad["G"],
                              B=bad["G"])
    independent = ac.call_async("elemental", "random_matrix", rows=4,
                                cols=4)
    with pytest.raises(AlchemistError, match="RuntimeError: boom"):
        bad.result()
    with pytest.raises(AlchemistError, match="upstream task"):
        dependent.result()
    assert independent.result()["A"].shape == (4, 4)   # not poisoned
    assert bad.state() == FAILED and independent.state() == DONE
    # chaining on a producer already known to have failed errors with a
    # clear message, client-side, instead of minting a doomed task
    with pytest.raises(AlchemistError, match="failed"):
        bad["G"]


def test_future_getitem_on_missing_output_key(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    fut = ac.call_async("elemental", "qr", A=ac.send_matrix(RNG.randn(8, 4)))
    fut.result()
    with pytest.raises(KeyError, match="no handle named"):
        fut["Z"]


def test_deferred_missing_key_fails_consumer_not_workers(engine):
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.2: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    ac.call_async("slow", "nap")             # keeps f1 QUEUED (deferred)
    f1 = ac.call_async("elemental", "random_matrix", rows=8, cols=4)
    f2 = ac.call_async("elemental", "gram", A=f1["NOPE"])
    with pytest.raises(AlchemistError, match="no handle named"):
        f2.result()
    # pool still alive
    assert ac.call("elemental", "random_matrix", rows=4,
                   cols=4)["A"].shape == (4, 4)


def test_blocking_calls_do_not_accumulate_task_rows(engine):
    """Delivery releases the table row: a long-lived session of blocking
    calls leaves the task table empty (the TaskLog keeps the accounting)."""
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    for i in range(5):
        ac.call("elemental", "random_matrix", rows=4, cols=4, seed=i)
    assert sum(engine.scheduler.counts().values()) == 0
    assert engine.task_log.session_summary(ac.session)["tasks"] == 5


def test_release_keeps_producer_row_for_terminal_data_dep():
    """Regression: a consumer whose data dep was already DONE at submit
    time still pins the producer's row until the consumer is terminal —
    otherwise a concurrent result delivery (wait -> release) between
    submit and execution drops the row and deferred resolution fails
    with "unknown task". Found by the traced-engine stress run
    (tests/test_analysis.py)."""
    sched = TaskScheduler(num_workers=1)
    gate = threading.Event()
    producer = sched.submit(lambda t: {"A": 7}, session=1)
    assert sched.wait(producer.id, timeout=10).state == DONE

    # occupy the single worker so the consumer stays QUEUED
    blocker = sched.submit(lambda t: gate.wait(10), session=1)
    consumer = sched.submit(
        lambda t: sched.task(producer.id).result["A"],
        session=1, data_deps=(producer.id,))

    # the delivery-time release must refuse while the consumer is live
    assert sched.release(producer.id) is False
    assert sched.task(producer.id).result == {"A": 7}

    gate.set()
    done = sched.wait(consumer.id, timeout=10)
    assert done.state == DONE and done.result == 7
    sched.wait(blocker.id, timeout=10)
    # ... and succeed once nothing depends on the row any more
    assert sched.release(producer.id) is True


def test_cross_session_deferred_is_refused_at_submit(engine):
    """Deferred handles are session-scoped: chaining on another tenant's
    task is rejected before a task (and a dependency edge onto the other
    session's work) is ever minted."""
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.3: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    engine.load_library("elemental", elemental)
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    a.call_async("slow", "nap")              # keeps fa QUEUED (deferred)
    fa = a.call_async("elemental", "random_matrix", rows=8, cols=4)
    with pytest.raises(AlchemistError, match="does not belong to session"):
        b.call_async("elemental", "gram", A=fa["A"])
    fa.result()


def test_disconnect_forgets_the_sessions_task_rows(engine):
    """Stop prunes the departed session's terminal tasks: the table stays
    bounded by connected tenants, and old task IDs stop resolving."""
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    futs = [ac.call_async("elemental", "random_matrix", rows=4, cols=4,
                          seed=i) for i in range(3)]
    futs[-1].result()
    tasks = [f.task for f in futs]
    ac.stop()
    for tid in tasks:
        with pytest.raises(KeyError):
            engine.scheduler.task(tid)
    # hazard maps are pruned too once nothing is in flight
    assert not engine.scheduler._readers and not engine.scheduler._writer


def test_submit_after_shutdown_returns_error_result(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    ac.send_matrix(RNG.randn(4, 4))
    engine.shutdown()
    assert engine.resident_bytes() == 0        # matrices dropped too
    # wire clients get a clean error Result (session gone), never a raw
    # exception; the scheduler itself refuses new work too
    with pytest.raises(AlchemistError, match="not connected"):
        ac.call_async("elemental", "random_matrix", rows=4, cols=4)
    with pytest.raises(RuntimeError, match="shut down"):
        engine.scheduler.submit(lambda t: None, session=0)
    engine.shutdown()                          # idempotent


def test_concurrent_waiters_on_one_task_both_get_results(engine):
    """Two threads waiting the same task race the release-on-delivery:
    the loser must get an encoded error Result (or the same values),
    never a raw exception through the wire endpoint."""
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    fut = ac.call_async("elemental", "random_matrix", rows=8, cols=8)
    outs = []

    def waiter():
        outs.append(protocol.decode_result(engine.task_op(
            protocol.encode_task_op(protocol.TaskOp(
                action=protocol.WAIT, task=fut.task,
                session=ac.session)))))

    ts = [threading.Thread(target=waiter) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(outs) == 4
    delivered = [r for r in outs if not r.error]
    assert delivered and all("A" in r.values for r in delivered)
    for r in outs:
        if r.error:                       # raced the release: clean error
            assert "unknown task" in r.error


def test_passing_future_directly_is_a_type_error(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    fut = ac.call_async("elemental", "random_matrix", rows=4, cols=4)
    with pytest.raises(TypeError, match="named output"):
        ac.call_async("elemental", "gram", A=fut)
    fut.result()


def test_task_ops_are_session_scoped(engine):
    engine.load_library("elemental", elemental)
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    fut = a.call_async("elemental", "random_matrix", rows=4, cols=4)
    res = protocol.decode_result(engine.task_op(protocol.encode_task_op(
        protocol.TaskOp(action=protocol.POLL, task=fut.task,
                        session=b.session))))
    assert "does not belong to session" in res.error
    fut.result()


def test_submit_fast_fails_without_minting_tasks(engine):
    before = engine.scheduler.counts()
    res = protocol.decode_result(engine.submit(b"\x00garbage"))
    assert res.error and res.task == 0
    wire = protocol.encode_command(protocol.Command(
        "elemental", "gram", {}, session=999))
    res = protocol.decode_result(engine.submit(wire))
    assert "UnknownSession" in res.error
    wire = protocol.encode_command(protocol.Command(
        "elemental", "gram", {}, session=0))
    res = protocol.decode_result(engine.submit(wire))
    assert "system session" in res.error
    assert engine.scheduler.counts() == before


def test_stop_drains_in_flight_tasks_before_reclaiming(engine):
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.3: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    ac = AlchemistContext(engine=engine)
    ac.send_matrix(RNG.randn(8, 4))
    fut = ac.call_async("slow", "nap")
    ac.stop()                      # must wait for the nap, then reclaim
    assert engine.resident_bytes() == 0
    # the nap ran to completion (drained, not cancelled)...
    rec = [r for r in engine.task_log.records if r.label == "slow.nap"]
    assert rec and rec[0].state == DONE
    # ...and the departed session's task rows were pruned
    with pytest.raises(KeyError):
        engine.scheduler.task(fut.task)


# ---- engine.overwrite: the write path hazards order against ----
def test_overwrite_in_place_keeps_id_and_refcount(engine):
    h = engine.put(np.zeros((4, 4), np.float32))
    engine.retain(h)
    engine.overwrite(h, np.asarray(np.ones((4, 4), np.float32)))
    assert engine.refcount(h) == 2
    np.testing.assert_array_equal(np.asarray(engine.get(h)),
                                  np.ones((4, 4), np.float32))


def test_overwrite_guards_shape_dtype_and_owner(engine):
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(RNG.randn(4, 4).astype(np.float32))
    with pytest.raises(ValueError, match="must keep shape"):
        engine.overwrite(al.handle, np.zeros((2, 2), np.float32))
    other = AlchemistContext(engine=engine)
    with pytest.raises(KeyError):
        engine.overwrite(al.handle, np.zeros((4, 4), np.float32),
                         session=other.session)


def test_declared_write_routine_is_hazard_tracked(engine):
    """A routine declaring writes=("A",) gets write edges: its effect is
    ordered against the session's surrounding reads."""
    def scale(eng, A, factor=2.0):
        eng.overwrite(A, eng.get(A) * factor)
        return {"A": A}
    scale.writes = ("A",)

    def total(eng, A):
        return {"sum": float(np.asarray(eng.get(A)).sum())}

    class _Lib:
        ROUTINES = {"scale": scale, "total": total}

    engine.load_library("w", _Lib)
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(np.ones((8, 2), np.float32))
    f1 = ac.call_async("w", "total", A=al)
    f2 = ac.call_async("w", "scale", A=al, factor=3.0)
    f3 = ac.call_async("w", "total", A=al)
    assert f1.result()["sum"] == 16.0
    assert f3.result()["sum"] == 48.0
    f2.result()


# =====================================================================
# register_library through the wire
# =====================================================================
def test_register_library_goes_through_the_wire(engine):
    ac = AlchemistContext(engine=engine)
    ac.register_library("elemental", elemental)
    assert "elemental" in engine.libraries()
    assert ac.call("elemental", "random_matrix", rows=4,
                   cols=4)["A"].shape == (4, 4)
    # registration executed as a command in this session
    assert any(r.label == f"{ENGINE_LIBRARY}.load_library"
               for r in engine.task_log.records)


def test_register_library_rejects_non_modules(engine):
    ac = AlchemistContext(engine=engine)

    class _NotAModule:
        ROUTINES = {}

    with pytest.raises(TypeError, match="import path"):
        ac.register_library("x", _NotAModule)


def test_register_library_bad_module_path_errors_cleanly(engine):
    ac = AlchemistContext(engine=engine)
    wire = protocol.encode_command(protocol.Command(
        ENGINE_LIBRARY, "load_library",
        {"name": "x", "module": "repro.no.such.module"},
        session=ac.session))
    res = protocol.decode_result(engine.run(wire))
    assert "ModuleNotFoundError" in res.error
    # the engine survives; later loads work
    ac.register_library("elemental", elemental)


def test_load_library_serializes_with_in_flight_tasks(engine):
    """The load is a barrier: a submission racing a slow task still sees
    the library once its turn comes (submit-time lookup is deferred)."""
    class _Slow:
        ROUTINES = {"nap": lambda eng, s=0.4: time.sleep(s) or {"ok": 1}}

    engine.load_library("slow", _Slow)
    a = AlchemistContext(engine=engine)
    b = AlchemistContext(engine=engine)
    nap = a.call_async("slow", "nap")
    b.register_library("elemental", elemental)      # barrier behind nap
    out = b.call("elemental", "random_matrix", rows=4, cols=4)
    assert out["A"].shape == (4, 4)
    nap.result()
    # barrier ordering is visible in the completion log
    labels = [r.label for r in engine.task_log.records]
    assert labels.index("slow.nap") < \
        labels.index(f"{ENGINE_LIBRARY}.load_library")


def test_reserved_library_name_cannot_be_shadowed(engine):
    with pytest.raises(ValueError, match="reserved"):
        engine.load_library(ENGINE_LIBRARY, elemental)


# =====================================================================
# the multi-threaded multi-session stress test
# =====================================================================
def test_stress_many_threads_many_sessions(engine):
    """N client threads × M sessions issuing interleaved async chains:
    namespace isolation, per-session ordering, hazard-correct chaining
    through deferred handles, failure isolation, real overlap."""
    engine.load_library("elemental", elemental)

    class _Aux:
        ROUTINES = {
            "nap": lambda eng, s=0.05: time.sleep(s) or {"ok": 1},
        }

    engine.load_library("aux", _Aux)

    num_threads = 4
    chains_per_thread = 3
    ctxs = [AlchemistContext(engine=engine, client_name=f"app-{i}")
            for i in range(num_threads)]
    errors: list[Exception] = []
    results: dict[int, list] = {i: [] for i in range(num_threads)}

    def work(ti: int, ac: AlchemistContext):
        try:
            for c in range(chains_per_thread):
                seed = 101 * ti + c
                f1 = ac.call_async("elemental", "random_matrix", rows=24,
                                   cols=6, seed=seed)
                ac.call_async("aux", "nap")        # keeps workers busy
                f2 = ac.call_async("elemental", "gram", A=f1["A"])
                f3 = ac.call_async("elemental", "multiply", A=f1["A"],
                                   B=f2["G"])
                if ti == 0 and c == 1:
                    # one session's failing routine...
                    ghost = MatrixHandle.fresh((3, 3), "float32")
                    bad = ac.call_async("elemental", "gram", A=ghost)
                    with pytest.raises(AlchemistError):
                        bad.result()
                out = f3.result()
                a = np.asarray(engine.get(f1["A"]))
                got = np.asarray(engine.get(out["C"]))
                results[ti].append((got, a @ (a.T @ a)))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, ac))
               for i, ac in enumerate(ctxs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert not errors
    # ...never poisons another session's futures: every chain of every
    # session (including the failing one's other chains) is correct
    for ti, pairs in results.items():
        assert len(pairs) == chains_per_thread
        for got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # concurrency was real: >1 task RUNNING at some point
    assert engine.scheduler.max_running_observed > 1
    # namespace isolation held: every handle minted by session i is owned
    # by session i only
    owned = [engine.session(ac.session).owned for ac in ctxs]
    for i in range(len(owned)):
        for j in range(i + 1, len(owned)):
            assert not (owned[i] & owned[j])
    # per-session program order: the task log records completions; within
    # a session, submission ids must complete respecting program order —
    # verified by per-session task wait/exec accounting being complete
    for ac in ctxs:
        summary = engine.task_log.session_summary(ac.session)
        assert summary["tasks"] >= 4 * chains_per_thread
        assert summary["p99_latency_s"] >= summary["p50_latency_s"] >= 0
    for ac in ctxs:
        ac.stop()
    assert engine.resident_bytes() == 0
