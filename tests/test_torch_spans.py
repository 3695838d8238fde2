"""The port's spans and counters (``repro_torch.common.spans``): off
without a profiler, on the profiler's clock when exported, and, for the
offload jobs through the client, one job id under ``engine.execute`` with
one span a CG iteration or a Lanczos step and a ``syncs`` count to match.
"""
import collections
import importlib
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.common import spans
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.kernels import device as kernel_device

RNG = np.random.default_rng(0)
X = RNG.standard_normal((512, 16)).astype(np.float32)
Y = RNG.standard_normal((512, 3)).astype(np.float32)
A = RNG.standard_normal((600, 40)).astype(np.float32)


@pytest.fixture()
def ac():
    spans.clear()
    engine = AlchemistEngine(device="cpu", cache_entries=0)
    ctx = AlchemistContext(engine=engine)
    for lib in ("skylark", "elemental"):
        ctx.register_library(lib, importlib.import_module(
            f"repro_torch.core.libraries.{lib}"))
    yield ctx
    ctx.stop()
    engine.shutdown()
    spans.clear()


def _cg(ac):
    w = ac.library("skylark").cg_solve(
        X=ac.send_matrix(X), Y=ac.send_matrix(Y), lam=1e-5, rf_dim=64,
        bandwidth=4.0, max_iters=5, tol=0.0, seed=3)
    return w.stats(), [w]


def _lanczos(ac):
    outs = ac.library("elemental").truncated_svd(A=ac.send_matrix(A), k=3,
                                                 oversample=4, seed=1)
    return outs[0].stats(), list(outs)


def _gram_svd(ac):
    outs = ac.library("elemental").gram_svd(A=ac.send_matrix(A), k=3)
    return outs[0].stats(), list(outs)


def _traced(ac, job):
    with profile(activities=[ProfilerActivity.CPU]):
        stats, outs = job(ac)
        for o in outs:
            o.to_numpy()
    return stats, spans.snapshot()


def test_nothing_is_recorded_without_a_profiler(ac):
    for job in (_cg, _lanczos, _gram_svd):
        _, outs = job(ac)
        for o in outs:
            o.to_numpy()
    snap = spans.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert not spans.recording()


def test_a_site_off_gets_the_shared_null_span():
    assert spans.span("anything", torch.ones(2), bytes=1) is spans.OFF
    spans.count("syncs")
    assert spans.snapshot()["counters"] == {}


def test_exported_spans_lie_inside_the_profiler_range_around_them(tmp_path):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with spans.client_job(7):
                with spans.span("a"):
                    time.sleep(0.002)
                    with spans.span("b", torch.ones(3, 2)):
                        time.sleep(0.002)
        with spans.client_job(8):
            with spans.span("c"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    recorded = spans.snapshot()["spans"]
    assert spans.export_chrome(str(path)) == len(recorded) == 3
    events = json.loads(path.read_text())["traceEvents"]
    mine = {e["args"]["id"]: e for e in events
            if e.get("cat") == spans.CATEGORY}
    assert set(mine) == {s.id for s in recorded}
    outer = next(e for e in events if e.get("name") == "outer")
    for s in recorded:
        e = mine[s.id]
        assert e["name"] == s.name and e["args"]["job"] == s.job
        assert e["tid"] == s.tid == outer["tid"]
        assert e["dur"] == pytest.approx((s.t1_ns - s.t0_ns) / 1e3)
    by_name = {mine[s.id]["name"]: mine[s.id] for s in recorded}
    for name in ("a", "b"):
        e = by_name[name]
        assert e["ts"] >= outer["ts"] - 200
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 200
    assert by_name["b"]["args"]["parent"] == by_name["a"]["args"]["id"]
    assert by_name["b"]["args"]["operands"] == [[[3, 2], 4]]
    assert by_name["c"]["args"]["job"] == 8


def _under_execute(snap, job):
    """The job's spans, each checked to descend from its engine.execute
    when it ran on the worker."""
    mine = [s for s in snap["spans"] if s.job == job]
    by_id = {s.id: s for s in mine}
    execute = [s for s in mine if s.name == "engine.execute"]
    assert len(execute) == 1
    for s in mine:
        if s.tid != execute[0].tid or s.name.startswith("engine."):
            continue
        up = s
        while up.parent:
            up = by_id[up.parent]
        assert up is execute[0], s.name
        assert execute[0].t0_ns <= s.t0_ns <= s.t1_ns <= execute[0].t1_ns
    return mine, execute[0]


def _jobs(snap):
    return sorted({s.job for s in snap["spans"] if s.name == "engine.execute"})


def test_cg_job_spans_and_syncs(ac):
    stats, snap = _traced(ac, _cg)
    [job] = _jobs(snap)
    mine, _ = _under_execute(snap, job)
    names = collections.Counter(s.name for s in mine)
    iters = stats["iterations"]
    assert iters == 5
    assert names["cg.iter"] == iters
    assert names["cg.sync"] == iters + 1
    assert names["kernel.normal_matvec"] == iters
    for once in ("cg.expand", "rf.weights", "kernel.rf_map", "cg.rhs",
                 "engine.queue", "engine.execute", "engine.handback",
                 "fetch", "fetch.collect"):
        assert names[once] == 1, once
    assert names["fetch.copy"] == names["fetch.place"] >= 1
    assert snap["counters"] == {job: {"syncs": iters + 1}}
    by_name = {s.name: s for s in mine}
    assert by_name["rf.weights"].parent == by_name["cg.expand"].id
    assert by_name["kernel.rf_map"].attrs["operands"] == [
        [[512, 16], 4], [[16, 64], 4], [[64], 4]]
    copies = [s for s in mine if s.name == "fetch.copy"]
    assert sum(s.attrs["bytes"] for s in copies) == \
        by_name["fetch"].attrs["bytes"] == 64 * 3 * 4
    assert all(s.attrs["pinned"] is False for s in copies)


def test_lanczos_job_spans_and_syncs(ac):
    stats, snap = _traced(ac, _lanczos)
    [job] = _jobs(snap)
    mine, _ = _under_execute(snap, job)
    names = collections.Counter(s.name for s in mine)
    steps = stats["lanczos_iters"]
    assert steps == 7
    for per_step in ("lanczos.step", "lanczos.matvec", "lanczos.reorth"):
        assert names[per_step] == steps, per_step
    assert names["lanczos.ritz"] == names["lanczos.u"] == 1
    assert names["fetch"] == names["fetch.collect"] == 3
    assert snap["counters"] == {job: {"syncs": steps}}
    steps_by_id = {s.id for s in mine if s.name == "lanczos.step"}
    assert all(s.parent in steps_by_id for s in mine
               if s.name in ("lanczos.matvec", "lanczos.reorth"))


def test_gram_svd_job_spans(ac):
    _, snap = _traced(ac, _gram_svd)
    [job] = _jobs(snap)
    mine, _ = _under_execute(snap, job)
    names = collections.Counter(s.name for s in mine)
    for once in ("gram_svd.gram", "kernel.gram", "gram_svd.eigh",
                 "gram_svd.u"):
        assert names[once] == 1, once
    gram = next(s for s in mine if s.name == "kernel.gram")
    assert gram.attrs["operands"] == [[[600, 40], 4]]
    assert snap["counters"] == {}


def test_queue_span_is_the_task_logs_wait(ac):
    _, snap = _traced(ac, _cg)
    [queue] = [s for s in snap["spans"] if s.name == "engine.queue"]
    [rec] = [r for r in ac.engine.task_log.records
             if r.label == "skylark.cg_solve"]
    assert queue.seconds == pytest.approx(rec.wait_s, abs=2e-9)
    by_name = {s.name: s for s in snap["spans"] if s.job == queue.job}
    assert queue.t1_ns == by_name["engine.execute"].t0_ns
    assert by_name["engine.execute"].t1_ns == \
        by_name["engine.handback"].t0_ns
    assert (by_name["engine.handback"].t1_ns
            - by_name["engine.execute"].t0_ns) / 1e9 == \
        pytest.approx(rec.exec_s, abs=2e-9)


def test_a_wrapper_in_a_capture_records_no_kernel_span():
    spans.clear()
    execute = spans.enter_job(1, True)
    try:
        a = torch.ones(4, 2)
        with kernel_device.capturing_launches():
            assert kernel_device.kernel_span("gram", a) is spans.OFF
        assert kernel_device.kernel_span("gram", a) is not spans.OFF
    finally:
        spans.RECORDER.local.job, spans.RECORDER.local.on = 0, False
        spans.RECORDER.local.open = []
    del execute
    spans.clear()


def test_the_recorder_is_bounded():
    rec = spans.Recorder(max_spans=2)
    for i in range(5):
        rec.add(spans.Span("s", 1, i, 0, 0, 0, 1, {}))
    snap = rec.snapshot()
    assert len(snap["spans"]) == 2 and snap["dropped"] == 3
    rec.clear()
    assert rec.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_go_on_the_trace_id_of_their_thread():
    """A thread the profiler did not run on appears in the trace under
    the low 32 bits of its pthread id (what CUPTI reports); the thread
    that ran it under its native id. The exporter puts each span there."""
    import threading
    seen = {}

    def worker():
        seen["native"] = spans.thread_id()
        seen["ident"] = threading.get_ident()

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    main = spans.thread_id()
    low = seen["ident"] & 0xFFFFFFFF
    events = [{"ph": "X", "cat": "cuda_runtime", "tid": low, "ts": 0,
               "dur": 1}, {"ph": "X", "cat": "cpu_op", "tid": main,
                           "ts": 0, "dur": 1}]
    tids = spans.trace_tids(events)
    assert tids[seen["native"]] == low and tids[main] == main
