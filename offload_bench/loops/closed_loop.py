"""The closed loop: one client (the paper's one Spark application) sends
offload jobs back to back through the client API and waits for each.

Set-up builds an in-process engine on the device with its result cache
off (every job stands for a new problem) and every other option at its
default, makes the cell's inputs on the device from the seed, hands them
over with ``send_matrix`` (the engine's device path: no host bridge) and
runs one job to warm every shape the window uses. A job is one
``ac.library(<library>).<routine>(...)`` call on the resident inputs,
then fetching every output to the client (``to_numpy``) and freeing it.
The job that is judged runs once the window has closed, so that neither
its spies nor their copies to the host are timed.
"""
from __future__ import annotations

import contextlib
import importlib
import math
import time
from dataclasses import dataclass, field

import numpy as np

from offload_bench import trace

# a run stops its loop after this many failed jobs in a row
MAX_FAILED_IN_A_ROW = 3


@dataclass
class Job:
    start: float
    end: float
    exec_s: float = math.nan
    fetch_s: float = math.nan
    error: str = ""
    arrays: dict = field(default_factory=dict)


def job_seed(seed: int) -> int:
    """The seed a job's routine takes (feature weights, Lanczos start):
    the run's seed folded into 31 bits."""
    return int(seed) % (2**31 - 1)


def resolve_args(traffic: dict, cfg: dict, seed: int) -> dict:
    """The routine's keyword arguments: ``config.<key>`` from the
    configuration, ``run.seed`` the job seed, anything else as written."""
    out = {}
    for name, value in traffic.get("args", {}).items():
        if isinstance(value, str) and value.startswith("config."):
            value = cfg[value[len("config."):]]
        elif value == "run.seed":
            value = job_seed(seed)
        out[name] = value
    return out


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 make_inputs, traced: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.make_inputs = make_inputs
        self.traced = traced
        self.args = resolve_args(traffic, cfg, seed)
        self.ac = self.engine = self.routine = None
        self.handles: dict = {}
        self.answer: dict = {}
        # wall-clock ns at each traced job's start, inside its profiler
        # range: what ties the host's clock to the trace's
        self.marks: list[int] = []

    def setup(self) -> None:
        from repro_torch.core import AlchemistContext, AlchemistEngine
        self.engine = AlchemistEngine(device=self.device, cache_entries=0)
        self.ac = AlchemistContext(engine=self.engine)
        library = self.traffic["library"]
        self.ac.register_library(library, importlib.import_module(
            f"repro_torch.core.libraries.{library}"))
        self.routine = getattr(self.ac.library(library),
                               self.traffic["routine"])
        inputs = self.make_inputs(self.cfg, self.seed, self.device)
        for slot, name in self.traffic["inputs"].items():
            self.handles[slot] = self.ac.send_matrix(inputs.pop(name),
                                                     dedup=False)
        del inputs
        warm = self.job()
        if warm.error:
            raise RuntimeError(f"the warm-up job failed: {warm.error}")

    def _range(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def job(self) -> Job:
        t0 = time.perf_counter()
        try:
            with self._range(trace.JOB_RANGE):
                if self.traced:
                    self.marks.append(time.time_ns())
                outs = self.routine(**self.handles, **self.args)
                outs = outs if isinstance(outs, tuple) else (outs,)
                stats = outs[0].stats()           # waits for the task
                t1 = time.perf_counter()
                with self._range("offload_bench.fetch"):
                    arrays = {name: o.to_numpy() for name, o in
                              zip(self.traffic["outputs"], outs)}
                t2 = time.perf_counter()
                for o in outs:
                    o.free()
        except Exception as e:      # a failed job is counted, not fatal
            return Job(start=t0, end=time.perf_counter(),
                       error=f"{type(e).__name__}: {e}")
        return Job(start=t0, end=time.perf_counter(), exec_s=stats["_elapsed"],
                   fetch_s=t2 - t1, arrays=arrays)

    def window(self, seconds: float) -> list[Job]:
        """Jobs back to back; every job that starts before ``seconds``
        have passed since the first one started counts, and the loop
        waits for the last to end. A job with a non-finite output is a
        failed job."""
        jobs: list[Job] = []
        self.marks = []
        t0 = time.perf_counter()
        failed_in_a_row = 0
        while time.perf_counter() - t0 < seconds:
            job = self.job()
            jobs.append(job)
            failed_in_a_row = failed_in_a_row + 1 if job.error else 0
            if failed_in_a_row >= MAX_FAILED_IN_A_ROW:
                break
        for job in jobs:
            if not job.error and not all(np.isfinite(a).all()
                                         for a in job.arrays.values()):
                job.error = "non-finite output"
            job.arrays = {}
        return jobs

    def judged_job(self, hooks) -> None:
        """One more job of the window's kind, on the same engine and
        inputs, run once the window has closed with the spies of
        ``hooks`` installed; its outputs and what the spies read are
        ``self.answer``."""
        hooks.install()
        try:
            job = self.job()
        finally:
            hooks.restore()
        self.answer = {"outputs": job.arrays, "spy": hooks.store,
                       "error": job.error}

    def close(self) -> None:
        """Free the inputs, disconnect the client, stop the engine."""
        for h in self.handles.values():
            h.free()
        self.handles.clear()
        if self.ac is not None:
            self.ac.stop()
        if self.engine is not None:
            self.engine.shutdown()
        self.ac = self.engine = self.routine = None
