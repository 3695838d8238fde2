"""One traced window of a cell with the program's spans merged into the
profiler's chrome trace, and the card's idle time split by the program
span that was running while it passed.

    python3 offload_bench/span_split.py --workload timit_cg.solve \\
        --seed 7 --seconds 10 [--trace-out merged.json]

(or ``python3 -m offload_bench.span_split ...``) from the root of a
checkout. It sets the cell up as ``run.py`` does, runs the window under
``torch.profiler``, exports the trace, adds the port's spans to it
(``repro_torch.common.spans.export_chrome``) and prints one JSON object:
the idle seconds inside the jobs by innermost program span (a job's
ranges that no span covers read ``offload_bench.job``), the share of that
idle time a program span names, each span's mean milliseconds a job, the
``syncs`` counter beside the host's waits the trace shows in each job's
``engine.execute``, and whether every kernel an engine worker launches
lies inside an ``engine.execute`` span (and every copy inside it or
``engine.handback``). It judges nothing; the benchmark's
numbers come from ``run.py``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "offload_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from offload_bench import trace  # noqa: E402

SPAN_CAT = "program_span"
# a launch may sit this far outside its job's engine.execute span: the
# spans' clock is tied to the trace's by one offset taken at import
SLACK_US = 100.0


def _segments(spans: list[dict]) -> list[tuple[float, float, str]]:
    """The timeline as (lo, hi, name of the innermost span open there):
    among the spans covering a moment, the one that started last."""
    edges = []
    for i, s in enumerate(spans):
        edges.append((float(s["ts"]), 1, i))
        edges.append((float(s["ts"]) + float(s["dur"]), 0, i))
    edges.sort()
    out, active, last = [], {}, None
    for t, opening, i in edges:
        if last is not None and t > last and active:
            inner = max(active.values())
            out.append((last, t, spans[inner[1]]["name"]))
        if opening:
            active[i] = (float(spans[i]["ts"]), i)
        else:
            active.pop(i, None)
        last = t
    return out


def _covered(lo: float, hi: float, segments, starts) -> list:
    """(seconds, name) of the parts of [lo, hi] the segments cover."""
    out = []
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(segments) and segments[i][0] < hi:
        a, b = max(lo, segments[i][0]), min(hi, segments[i][1])
        if b > a:
            out.append(((b - a) / 1e6, segments[i][2]))
        i += 1
    return out


def split(events: list[dict], counters: dict | None = None) -> dict:
    """The breakdown of a merged trace's complete events (see the module
    docstring); ``counters`` maps a job id to its counters."""
    jobs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == trace.JOB_RANGE)
    if not jobs:
        return {}
    w0, w1 = jobs[0][0], jobs[-1][1]
    device = [(float(e["ts"]), float(e["dur"])) for e in events
              if e.get("cat") in trace.DEVICE_CATS]
    busy = trace.merged(trace.clip(device, w0, w1))
    program = [e for e in events if e.get("cat") == SPAN_CAT]
    segments = _segments(program)
    starts = [s[0] for s in segments]

    idle: dict[str, float] = {}
    edge = w0
    gaps = []
    for lo, hi in busy + [(w1, w1)]:
        if lo - edge >= trace.MIN_GAP_US:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    in_jobs = named = 0.0
    for lo, hi in gaps:
        for a, b in _jobs_parts(lo, hi, jobs):
            in_jobs += (b - a) / 1e6
            for secs, name in _covered(a, b, segments, starts):
                idle[name] = idle.get(name, 0.0) + secs
                named += secs
    idle[trace.JOB_RANGE] = in_jobs - named

    execute = [e for e in program if e["name"] == "engine.execute"]
    per_job: dict[str, float] = {}
    for e in program:
        per_job[e["name"]] = per_job.get(e["name"], 0.0) + float(e["dur"])
    n_jobs = max(1, len(execute))
    return {
        "jobs": len(execute),
        "window_s": (w1 - w0) / 1e6,
        "idle_in_jobs_s": in_jobs,
        "named_share_pct": 100.0 * named / in_jobs if in_jobs else None,
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "span_ms_per_job": {k: v / 1e3 / n_jobs for k, v in
                            sorted(per_job.items(), key=lambda kv: -kv[1])},
        "syncs": _syncs(events, execute, counters or {}),
        "launches": _launches(events, program),
    }


def _jobs_parts(lo: float, hi: float, jobs) -> list[tuple[float, float]]:
    """The parts of [lo, hi] inside the jobs' ranges."""
    return [(max(lo, a), min(hi, b)) for a, b in jobs
            if min(hi, b) > max(lo, a)]


def _syncs(events, execute, counters) -> dict:
    """Per job: the ``syncs`` counter and the host waits (runtime
    ``*Synchronize`` calls) the trace shows on the worker inside the
    job's ``engine.execute``; their means over the jobs."""
    waits = [e for e in events if e.get("cat") in trace.LAUNCH_CATS
             and "Synchronize" in e.get("name", "")]
    counted, seen = [], []
    for x in execute:
        lo, hi = float(x["ts"]), float(x["ts"]) + float(x["dur"])
        seen.append(sum(1 for e in waits if e.get("tid") == x["tid"]
                        and lo <= float(e["ts"]) <= hi))
        counted.append(counters.get(x["args"]["job"], {}).get("syncs", 0))
    n = max(1, len(execute))
    return {"counter_mean": sum(counted) / n,
            "trace_waits_mean": sum(seen) / n,
            "trace_waits_per_job": seen}


def _launches(events, program) -> dict:
    """Launches (runtime calls that put device work in the trace) on the
    engine's worker threads: how many kernels fall outside every
    ``engine.execute`` span on their thread, and how many launches of any
    kind outside both ``engine.execute`` and ``engine.handback`` (which
    moves host outputs to the card), each by more than ``SLACK_US``."""
    kinds = {e.get("args", {}).get("correlation"): e.get("cat")
             for e in events if e.get("cat") in trace.DEVICE_CATS}
    spans_by_tid: dict = {}
    for x in program:
        if x["name"] in ("engine.execute", "engine.handback"):
            spans_by_tid.setdefault(x["tid"], []).append(
                (x["name"], float(x["ts"]), float(x["ts"]) + float(x["dur"])))
    n = kernels_out = out = 0
    worst = 0.0
    for e in events:
        kind = kinds.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in trace.LAUNCH_CATS or kind is None or \
                e.get("tid") not in spans_by_tid:
            continue
        n += 1
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        miss = {name: min((max(lo - t0, t1 - hi, 0.0) for nm, lo, hi in
                           spans_by_tid[e["tid"]] if nm == name),
                          default=float("inf"))
                for name in ("engine.execute", "engine.handback")}
        kernels_out += kind == "kernel" and miss["engine.execute"] > SLACK_US
        job_miss = min(miss.values())
        worst = max(worst, job_miss)
        out += job_miss > SLACK_US
    return {"on_workers": n, "kernels_outside_execute": kernels_out,
            "outside_job": out, "worst_us": worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m offload_bench.span_split")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace-out", default=None,
                   help="keep the merged chrome trace at this path")
    args = p.parse_args(argv)
    from offload_bench import harness, run
    run.prepare_environment()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("span_split needs a CUDA card", file=sys.stderr)
        return 2

    from repro_torch.common import spans
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    ref = harness.config_module(cell)
    drv = harness.loop_module(cell).Loop(cell.config, cell.traffic,
                                         args.seed, "cuda", ref.make_inputs,
                                         traced=True)
    drv.setup()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.window(args.seconds)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(args.trace_out or Path(tmp) / "trace.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        written = spans.export_chrome(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    out = split(events, spans.snapshot()["counters"])
    out.update(cell=args.workload, seed=args.seed, spans_written=written,
               device=torch.cuda.get_device_name(0))
    drv.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
