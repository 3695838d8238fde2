"""The readers of the program's spans and counters (``queue_ms``,
``host_compute_ms``, ``syncs_per_job``, ``fetch_GBps``) in tiny runs of
every cell on the CPU, and the idle split of ``span_split.py``.

    python -m pytest -q offload_bench/tests
"""
from __future__ import annotations

import json

import pytest

from test_offload_bench_contract import (BENCH, CELLS, SEED, run_small,
                                         small_cell)

from offload_bench import harness, span_split, trace

SPAN_METRICS = {"queue_ms", "host_compute_ms", "syncs_per_job", "fetch_GBps"}


def _spans():
    from repro_torch.common import spans
    return spans


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_run_reports_the_span_metrics(cell):
    _spans().clear()
    result = run_small(cell, traced=True)
    assert result["correct"] is True, result["checks"]
    c = small_cell(cell)
    want = {m["name"] for m in c.per_layer} & SPAN_METRICS
    assert want >= {"queue_ms", "fetch_GBps"}
    got = result["metrics"]
    assert want <= set(got), sorted(got)
    assert got["fetch_GBps"]["value"] > 0
    assert got["queue_ms"]["value"] >= 0
    if cell == "timit_cg.solve":
        assert got["syncs_per_job"]["value"] == c.config["max_iters"] + 1
    if cell == "ocean_svd.lanczos":
        steps = min(c.config["d"], c.config["k"] + c.traffic["args"][
            "oversample"])
        assert got["syncs_per_job"]["value"] == steps == 52
    if "host_compute_ms" in want:
        assert got["host_compute_ms"]["value"] > 0
    _spans().clear()


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_none_and_records_nothing(cell):
    _spans().clear()
    result = run_small(cell, traced=False)
    assert result["correct"] is True
    assert not set(result["metrics"]) & SPAN_METRICS
    snap = _spans().snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def test_readers_read_nothing_from_an_empty_recorder():
    _spans().clear()
    for name in SPAN_METRICS:
        assert harness.reader(name).read(None) is None, name


def test_span_metrics_are_entries_of_their_layers():
    layers = {m["layer"] for m in BENCH["per_layer"]
              if m["name"] not in SPAN_METRICS}
    for m in BENCH["per_layer"]:
        if m["name"] in SPAN_METRICS:
            assert m["layer"] in layers and m["moves"] == "job_s"
            assert m["source"] in ("program_span", "program_counter")


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_split_names_idle_time_by_the_innermost_span():
    """Two device intervals in one job leave three gaps: 100 us under
    ``w`` inside ``execute``, 50 us under ``execute`` alone, and 150 us
    that no span covers; one kernel launch lies 300 us past its execute
    span, and a copy launched in the hand-back lies inside the job."""
    events = [
        _ev(trace.JOB_RANGE, "user_annotation", 0, 1000),
        _ev("engine.execute", "program_span", 0, 700, tid=2, job=5, id=1),
        _ev("w", "program_span", 0, 100, tid=2, job=5, id=2, parent=1),
        _ev("k", "kernel", 100, 500, correlation=9),
        _ev("k", "kernel", 650, 200, correlation=10),
        _ev("cudaLaunchKernel", "cuda_runtime", 99, 1, tid=2,
            correlation=9),
        _ev("cudaLaunchKernel", "cuda_runtime", 1000, 1, tid=2,
            correlation=10),
        _ev("cudaStreamSynchronize", "cuda_runtime", 300, 350, tid=2),
        _ev("engine.handback", "program_span", 700, 150, tid=2, job=5,
            id=3),
        _ev("copy", "gpu_memcpy", 720, 10, correlation=11),
        _ev("cudaMemcpyAsync", "cuda_runtime", 710, 5, tid=2,
            correlation=11),
    ]
    out = span_split.split(events, {5: {"syncs": 1}})
    assert out["jobs"] == 1
    assert out["idle_in_jobs_s"] == pytest.approx(300e-6)
    assert out["idle_s"]["w"] == pytest.approx(100e-6)
    assert out["idle_s"]["engine.execute"] == pytest.approx(50e-6)
    assert out["idle_s"][trace.JOB_RANGE] == pytest.approx(150e-6)
    assert out["named_share_pct"] == pytest.approx(50.0)
    assert out["syncs"]["counter_mean"] == 1
    assert out["syncs"]["trace_waits_per_job"] == [1]
    assert out["launches"] == {"on_workers": 3, "kernels_outside_execute": 1,
                               "outside_job": 1,
                               "worst_us": pytest.approx(151.0)}


def test_split_of_a_tiny_traced_window_on_the_cpu(tmp_path):
    """The tool's path at a tiny size: a window under the profiler, the
    spans merged into its trace, every launch-free CPU job split."""
    from torch.profiler import ProfilerActivity, profile
    spans = _spans()
    c = small_cell("timit_cg.solve")
    ref = harness.config_module(c)
    drv = harness.loop_module(c).Loop(c.config, c.traffic, SEED, "cpu",
                                      ref.make_inputs, traced=True)
    drv.setup()
    try:
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            jobs = drv.window(0.3)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        assert spans.export_chrome(str(path)) > 0
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
        out = span_split.split(events, spans.snapshot()["counters"])
    finally:
        drv.close()
        spans.clear()
    assert out["jobs"] == len(jobs) >= 1
    assert out["syncs"]["counter_mean"] == c.config["max_iters"] + 1
    assert out["span_ms_per_job"]["engine.execute"] > 0
    assert out["launches"]["outside_job"] == 0
