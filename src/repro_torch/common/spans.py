"""Spans and counters of the offload path, stamped on the host's
``perf_counter`` clock and placed on a ``torch.profiler`` trace.

A span is one named piece of a job's work on one thread: the engine's
queue, execute and hand-back of a task (``core/scheduler.py``,
``core/engine.py``), the phases of a backend routine
(``core/backends/``), a kernel wrapper's call (``kernels/*/ops.py``) and
the client's fetch (``core/transfer.py``, ``core/expr.py``). Each carries
the job id (the scheduler's task id), its parent span, the native thread
id, its start and end in ``perf_counter_ns`` and a few attributes.
Counters are named integers kept for each job (``syncs``: how often a
routine waited on the device from the host).

Recording is on for a job when a ``torch.profiler`` was recording on the
thread that submitted it: the scheduler reads the profiler's flag once at
submit and the worker makes the job current on its thread
(:func:`enter_job`); the client reads the flag itself around a fetch
(:func:`client_job`). There is no other switch. With recording off a
span site costs one thread-local read. A span never touches the device.

Everything stays in one process-wide :class:`Recorder` (like the kernels'
``LaunchCounter``), in memory and bounded, until it is read
(:func:`snapshot`) or emptied (:func:`clear`). :func:`export_chrome`
writes the spans into a chrome trace that ``torch.profiler`` exported,
on their threads and on the trace's clock, so that they sit beside the
device's kernels::

    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        ...                                    # jobs through the client
    prof.export_chrome_trace("trace.json")
    spans.export_chrome("trace.json")          # adds the program's spans
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis import locktrace

#: the most spans the recorder holds; later ones are counted as dropped
MAX_SPANS = 1 << 18
#: chrome-trace category of the program's spans
CATEGORY = "program_span"
#: categories of a profiler trace's host events, on a thread's track
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")

# perf_counter_ns -> Unix ns, taken once: the midpoint of two reads of the
# monotonic clock around one of the wall clock
_a = time.perf_counter_ns()
_unix = time.time_ns()
UNIX_OFFSET_NS = _unix - (_a + time.perf_counter_ns()) // 2
del _a, _unix


def ns(seconds: float) -> int:
    """A ``time.perf_counter()`` reading in ``perf_counter_ns`` units."""
    return round(seconds * 1e9)


def profiling() -> bool:
    """True while a ``torch.profiler`` records on this thread."""
    return torch.autograd._profiler_enabled()


class Span(NamedTuple):
    """One recorded span: ``parent`` is the id of the span open around it
    on its thread (0 for none), ``tid`` the native thread id."""
    name: str
    job: int
    id: int
    parent: int
    tid: int
    t0_ns: int
    t1_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class _Thread(threading.local):
    """What one thread is recording for: its current job (0 for none),
    whether that job records, and the ids of its open spans. On its first
    use in a thread it notes the thread's native id, and the pthread id
    under which it is known there, in ``idents``."""

    def __init__(self, idents: dict) -> None:
        self.job = 0
        self.on = False
        self.open: list[int] = []
        self.tid = threading.get_native_id()
        idents[self.tid] = threading.get_ident()


def describe(t) -> list:
    """A tensor operand as [shape, itemsize]: what counting a kernel's
    operations and bytes needs."""
    return [list(t.shape), t.element_size()]


class Recorder:
    """The spans and per-job counters of the jobs that record. A span is
    kept as a plain tuple until it is read (:meth:`snapshot`)."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        self.max_spans = max_spans
        self._lock = locktrace.make_lock("spans.recorder")
        self._spans: list[tuple] = []
        self._counters: dict[int, dict[str, int]] = {}
        self._ids = itertools.count(1)
        self.dropped = 0
        # native thread id -> pthread id, of every thread that used it
        self.idents: dict[int, int] = {}
        self.local = _Thread(self.idents)

    def next_id(self) -> int:
        return next(self._ids)

    def add(self, record: tuple) -> None:
        """Keep one span, given as the fields of :class:`Span` in order."""
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(record)
            else:
                self.dropped += 1

    def count(self, job: int, name: str, n: int) -> None:
        with self._lock:
            per_job = self._counters.setdefault(job, {})
            per_job[name] = per_job.get(name, 0) + n

    def snapshot(self) -> dict:
        """{"spans": [Span], "counters": {job: {name: n}}, "dropped": n},
        copies of what is recorded so far."""
        with self._lock:
            records = list(self._spans)
            counters = {j: dict(c) for j, c in self._counters.items()}
            dropped = self.dropped
        return {"spans": [Span(*r[:7], dict(r[7] or {})) for r in records],
                "counters": counters, "dropped": dropped}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self.dropped = 0


RECORDER = Recorder()
_local = RECORDER.local
_ids = RECORDER.next_id
_clock = time.perf_counter_ns


class _Open:
    """A span being recorded: opened on entry (or with a given start),
    recorded when it closes. Attributes may be added while it is open."""

    __slots__ = ("name", "job", "id", "parent", "tid", "t0", "attrs",
                 "operands")

    def __init__(self, name: str, attrs: Optional[dict], operands=(),
                 t0_ns: Optional[int] = None) -> None:
        local = _local
        self.name, self.attrs, self.operands = name, attrs, operands
        self.job, self.tid = local.job, local.tid
        self.id = _ids()
        self.parent = local.open[-1] if local.open else 0
        local.open.append(self.id)
        self.t0 = _clock() if t0_ns is None else t0_ns

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def close(self, t1_ns: Optional[int] = None) -> None:
        t1 = _clock() if t1_ns is None else t1_ns
        opened = _local.open
        if opened and opened[-1] == self.id:
            opened.pop()
        if self.operands:
            self.set(operands=[describe(t) for t in self.operands])
        RECORDER.add((self.name, self.job, self.id, self.parent, self.tid,
                      self.t0, t1, self.attrs))

    def __enter__(self) -> "_Open":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Off:
    """What a span site gets while its thread does not record."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def close(self, t1_ns: Optional[int] = None) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


OFF = _Off()


def recording() -> bool:
    """True while this thread records for its current job."""
    return _local.on


def span(name: str, *operands, **attrs):
    """A context manager recording ``name`` over its block for this
    thread's current job, or :data:`OFF` where the thread does not record.
    ``operands`` are tensors described (shape, itemsize) when the span
    closes, so that a site pays nothing for them while recording is off."""
    if not _local.on:
        return OFF
    return _Open(name, attrs or None, operands)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to this thread's current job's counter ``name``."""
    if _local.on:
        RECORDER.count(_local.job, name, n)


def thread_id() -> int:
    """This thread's native id, as spans record it."""
    return _local.tid


def enter_job(job: int, on: bool, start_s: float = 0.0):
    """Make ``job`` this thread's current job, recording when ``on``; with
    ``on``, opens its ``engine.execute`` span at ``start_s`` (a
    ``perf_counter`` reading) and returns it, else returns None. Undone
    by :func:`leave_job`."""
    local = _local
    local.job, local.on, local.open = job, on, []
    if not on:
        return None
    return _Open("engine.execute", None, (), ns(start_s))


def leave_job(execute, task) -> None:
    """Record a finished task's ``engine.queue``, ``engine.execute`` and
    ``engine.handback`` from the scheduler's own stamps (``submitted_at``,
    ``started_at``, ``executed_at``, ``finished_at``) and clear this
    thread's current job. ``execute`` is what :func:`enter_job` returned."""
    if execute is not None:
        executed = task.executed_at or task.finished_at
        execute.close(ns(executed))
        RECORDER.add(("engine.queue", task.id, _ids(), 0, task.submit_tid,
                      ns(task.submitted_at), ns(task.started_at), None))
        if task.executed_at:
            RECORDER.add(("engine.handback", task.id, _ids(), 0,
                          execute.tid, ns(task.executed_at),
                          ns(task.finished_at), None))
    local = _local
    local.job, local.on, local.open = 0, False, []


class client_job:
    """Around client work for ``job`` (a fetch of its outputs): records on
    this thread while a ``torch.profiler`` records here, and puts back
    what the thread recorded for before."""

    __slots__ = ("job", "saved")

    def __init__(self, job: int) -> None:
        self.job = job

    def __enter__(self) -> "client_job":
        local = _local
        self.saved = (local.job, local.on, local.open)
        if profiling():
            local.job, local.on, local.open = self.job, True, []
        return self

    def __exit__(self, *exc) -> None:
        local = _local
        local.job, local.on, local.open = self.saved


def snapshot() -> dict:
    return RECORDER.snapshot()


def clear() -> None:
    RECORDER.clear()


def _chrome_events(base_time_ns: int, pid=0, tids=None) -> list[dict]:
    """The recorded spans as chrome-trace complete ("X") events, in
    microseconds after ``base_time_ns`` (Unix ns, a profiler trace's
    ``baseTimeNanoseconds``). ``tids`` maps a span's native thread id to
    the id a trace gives that thread (the native id where absent). A
    job's counters ride in the args of its ``engine.execute`` event."""
    snap = RECORDER.snapshot()
    tids = tids or {}
    out = []
    for s in snap["spans"]:
        args = {"job": s.job, "id": s.id, "parent": s.parent, **s.attrs}
        if s.name == "engine.execute" and s.job in snap["counters"]:
            args["counters"] = snap["counters"][s.job]
        out.append({"ph": "X", "cat": CATEGORY, "name": s.name, "pid": pid,
                    "tid": tids.get(s.tid, s.tid),
                    "ts": (s.t0_ns + UNIX_OFFSET_NS - base_time_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    return out


def trace_tids(events: list[dict]) -> dict[int, int]:
    """Native thread id -> the id the trace ``events`` give that thread:
    the native id where the trace has host events under it (the thread
    that ran the profiler), else the pthread id as Kineto writes what
    CUPTI reports for other threads (its low 32 bits)."""
    seen = {e.get("tid") for e in events if e.get("cat") in HOST_CATS}
    out = {}
    for native, ident in list(RECORDER.idents.items()):
        low = ident & 0xFFFFFFFF
        for cand in (native, low, low - (1 << 32)):
            if cand in seen:
                out[native] = cand
                break
    return out


def export_chrome(path) -> int:
    """Add the recorded spans to the chrome trace ``torch.profiler``
    exported at ``path`` (in place): placed by its
    ``baseTimeNanoseconds``, in the process of its host events, each on
    the id the trace gives its thread (:func:`trace_tids`). Returns the
    number of spans written."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    pids = [e["pid"] for e in events
            if e.get("cat") in ("cpu_op", "user_annotation")]
    extra = _chrome_events(int(trace.get("baseTimeNanoseconds", 0)),
                          pids[0] if pids else 0, trace_tids(events))
    events.extend(extra)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(extra)
