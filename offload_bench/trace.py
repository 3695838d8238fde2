"""What a traced run reads from ``torch.profiler``'s chrome trace: device
intervals, the busy union, the device time launched by the calls of an
entry point, and the breakdown the result line carries.

The calls of an entry (``hooks.py``) come with their thread and their
start and end on the host's wall clock. The trace's clock is tied to that
one by the jobs' profiler ranges, whose starts the loop also stamps on
the wall clock; a call's device work is then every kernel, copy and set
whose launch the CUDA runtime saw on the call's thread inside the call
(widened by ``PAD_US`` for the tie's error), found by correlation id.

The union arithmetic is a copy of the port's ``launch/profile_serve.py``
(``kernel_spans``, ``busy_us``), kept here so the yardstick stays put.
"""
from __future__ import annotations

import bisect
import json
import math
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
JOB_RANGE = "offload_bench.job"
PAD_US = 100.0
MIN_GAP_US = 5.0
SCAN_BACK = 2000
TOP = 10


def union_us(spans) -> float:
    """Length of the union of (start, duration) intervals."""
    busy, end = 0.0, -math.inf
    for ts, dur in sorted(spans):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, duration) intervals as sorted (lo, hi)."""
    out: list[list[float]] = []
    for ts, dur in sorted(spans):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return [(lo, hi) for lo, hi in out]


def clip(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    out = []
    for ts, dur in spans:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b > a:
            out.append((a, b - a))
    return out


@dataclass
class TraceView:
    busy_s: float
    window_s: float
    entries: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def load_events(prof) -> list[dict]:
    """The chrome trace's complete events, through a file under TMPDIR."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def read(events: list[dict], marks: list[int] | None = None,
         calls: dict | None = None) -> TraceView:
    """Busy union and window between the first job range's start and the
    last one's end; the device seconds of each entry's ``calls`` (tied to
    the trace by ``marks``, the jobs' starts in wall-clock ns); the top
    device operations and idle gaps."""
    jobs = [e for e in events if e.get("name") == JOB_RANGE]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if jobs:
        w0 = min(float(e["ts"]) for e in jobs)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in jobs)
    elif device:
        w0 = min(float(e["ts"]) for e in device)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
    else:
        return TraceView(busy_s=0.0, window_s=0.0)
    spans = clip([(float(e["ts"]), float(e["dur"])) for e in device], w0, w1)
    view = TraceView(busy_s=union_us(spans) / 1e6, window_s=(w1 - w0) / 1e6)
    view.entries = _entries(events, device, _offset_us(jobs, marks or []),
                            calls or {})
    view.device_ops = _top_ops(device, w0, w1)
    view.idle_gaps = _idle_gaps(events, spans, w0, w1)
    return view


def _offset_us(jobs, marks) -> float | None:
    """Trace microseconds minus wall-clock microseconds, the median over
    the jobs (the i-th range against the i-th stamp)."""
    starts = sorted(float(e["ts"]) for e in jobs)
    if not marks or len(starts) != len(marks):
        return None
    diffs = sorted(ts - m / 1e3 for ts, m in zip(starts, sorted(marks)))
    return diffs[len(diffs) // 2]


def _entries(events, device, offset_us, calls) -> dict:
    """Entry -> device seconds: over its calls, the union of the device
    intervals whose launch sits on the call's thread inside the call."""
    if offset_us is None:
        return {}
    by_corr: dict = {}
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr.setdefault(corr, []).append(
                (float(e["ts"]), float(e["dur"])))
    launches: dict = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr in by_corr:
                launches.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    out: dict = {}
    for entry, entry_calls in calls.items():
        for call in entry_calls:
            lo = call["t0_ns"] / 1e3 + offset_us - PAD_US
            hi = call["t1_ns"] / 1e3 + offset_us + PAD_US
            # a thread the trace does not know by that id: every thread's
            # launches (one job runs at a time, so none is another's)
            on_thread = launches.get(call["tid"]) or sorted(
                x for v in launches.values() for x in v)
            i = bisect.bisect_left(on_thread, (lo, -math.inf))
            spans = []
            while i < len(on_thread) and on_thread[i][0] <= hi:
                spans.extend(by_corr[on_thread[i][1]])
                i += 1
            out[entry] = out.get(entry, 0.0) + union_us(spans) / 1e6
    return out


def _top_ops(device, w0, w1) -> list:
    total: dict = {}
    for e in device:
        for _, dur in clip([(float(e["ts"]), float(e["dur"]))], w0, w1):
            total[e["name"]] = total.get(e["name"], 0.0) + dur / 1e6
    return [[name, s] for name, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def _idle_gaps(events, device_spans, w0, w1) -> list:
    """Idle time of the device in the window, summed by the innermost
    host event running at each gap's midpoint ("no host op" where none
    was traced there)."""
    busy = merged(device_spans)
    gaps, edge = [], w0
    for lo, hi in busy:
        if lo - edge >= MIN_GAP_US:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    if w1 - edge >= MIN_GAP_US:
        gaps.append((edge, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    starts = [h[0] for h in host]
    total: dict = {}
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        # the innermost event starts shortly before the midpoint: look
        # back a bounded way, which keeps long windows cheap to read
        for ts, end, name in reversed(host[max(0, i - SCAN_BACK):i]):
            if end >= mid and (best is None or end - ts < best[0]):
                best = (end - ts, name)
        label = best[1] if best else "no host op"
        total[label] = total.get(label, 0.0) + (hi - lo) / 1e6
    return [[name, s] for name, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
