"""One run of one cell: set-up, the measured window, the readers, the
judgement and the result line. Everything that belongs to one
configuration, traffic mix, metric or cell is a file of its own, found by
the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run; beside it
  ``configs/<config>.py``: its inputs from the seed, its spies, the plain
  reference that judges a job and the control (see ``configs/*.py``);
* ``traffic/<traffic>.json``: the mix, run by ``loops/<loop>.py``;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, with
  an optional ``ENTRY`` of the system that a traced run wraps in a range;
* ``limits/<cell>.json``: the numbers a job is judged on, each with its
  limit.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from offload_bench import counts, hooks as hooks_mod, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules the process that prints a result may not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict
    config_file: Path
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str,
              config_overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``) with its files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config_file = ROOT / conf["file"]
    config = read_json(config_file)
    config.update(config_overrides or {})
    return Cell(
        name=name, config=config, config_file=config_file,
        traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        limits=read_json(HERE / "limits" / f"{name}.json"))


def config_module(cell: Cell):
    return load_module(cell.config_file.with_suffix(".py"),
                       f"offload_bench_config_{cell.config['name']}")


def reader(metric_name: str):
    return load_module(HERE / "metrics" / f"{metric_name}.py",
                       f"offload_bench_metric_{metric_name}")


def loop_module(cell: Cell):
    name = cell.traffic["loop"]
    return load_module(HERE / "loops" / f"{name}.py",
                       f"offload_bench_loop_{name}")


@dataclass
class Run:
    """What the readers read."""
    cell: str
    config: dict
    traffic: dict
    args: dict
    seed: int
    setup_s: float
    jobs: list
    peak_window_bytes: float | None = None
    trace: trace.TraceView | None = None
    calls: dict = field(default_factory=dict)

    @property
    def job_s(self) -> float | None:
        if not self.jobs:
            return None
        return (self.jobs[-1].end - self.jobs[0].start) / len(self.jobs)

    def roofline_pct(self, entry: str, count) -> float | None:
        """Least time over device time, in %, of every traced call of
        ``entry``; ``count(call_args)`` gives a call's (operations, bytes)
        from its arguments' descriptions. None where nothing was read."""
        calls = self.calls.get(entry)
        device_s = self.trace.entries.get(entry) if self.trace else None
        if not calls or not device_s:
            return None
        least = sum(counts.least_seconds(*count(c["args"])) for c in calls)
        return 100.0 * least / device_s


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(torch, device) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def compare(numbers: dict, limits: dict) -> dict:
    """name -> {value, limit} for each number the cell's limits name; a
    number that is missing or not finite reads inf and fails."""
    out = {}
    for name, spec in limits["numbers"].items():
        value = float(numbers.get(name, math.inf))
        if not math.isfinite(value):
            value = math.inf
        out[name] = {"value": value, "limit": float(spec["limit"])}
    return out


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, log=print) -> tuple[dict, dict, dict]:
    """Set-up, the window, the readers and, once the window has closed,
    the judged job; the program's state freed after. Returns (the result
    line so far, the judged job's answer, the routine's arguments)."""
    import torch
    on_card = torch.device(device).type == "cuda"
    ref = config_module(cell)
    drv = loop_module(cell).Loop(cell.config, cell.traffic, seed, device,
                                     ref.make_inputs, traced=traced)
    drv.setup()
    peak_bytes = None
    if on_card:
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    readers = {m["name"]: reader(m["name"])
               for m in (cell.per_layer if traced else cell.end_to_end)}
    entries = {getattr(r, "ENTRY", None) for r in readers.values()} - {None}
    hk = hooks_mod.Hooks({}, entries if traced else set())
    hk.install()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
    try:
        with prof or contextlib.nullcontext():
            jobs = drv.window(seconds)
            if on_card:
                torch.cuda.synchronize()
    finally:
        hk.restore()
    window_peak = None
    if on_card:
        window_peak = torch.cuda.max_memory_allocated()
        peak_bytes = max(peak_bytes, window_peak)
    view = trace.read(trace.load_events(prof), drv.marks, hk.calls) \
        if prof is not None else None
    del prof
    drv.judged_job(hooks_mod.Hooks(
        ref.spies(cell.config, cell.traffic, seed), set()))
    run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic,
              args=drv.args, seed=seed, setup_s=setup_s,
              jobs=[j for j in jobs if not j.error],
              peak_window_bytes=window_peak, trace=view, calls=hk.calls)
    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name, r in readers.items():
        value = r.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    log("job seconds " + " ".join(repr(j.end - j.start) for j in jobs))
    for j in jobs:
        if j.error:
            log(f"job failed: {j.error}")
    answer, args = drv.answer, drv.args
    drv.close()
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dev = _device_info(torch, device)
    dev["memory_peak_bytes"] = peak_bytes
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    failed = sum(1 for j in jobs if j.error)
    result = {"correct": False, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if view is not None:
        result["breakdown"] = {"device_ops": view.device_ops,
                               "idle_gaps": view.idle_gaps}
    return result, answer, args


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=print) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    result, answer, args = measure(cell, seed, seconds, traced, device,
                                   t_start, log)
    t0 = time.perf_counter()
    numbers = config_module(cell).judge(cell.config, cell.traffic, args,
                                        seed, answer, device)
    result["judge_s"] = time.perf_counter() - t0
    if answer.get("error"):
        log(f"judged job failed: {answer['error']}")
    checks = compare(numbers, cell.limits)
    result["correct"] = result["attempted"] > 0 and \
        result["failed"] == 0 and not answer.get("error") and \
        all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result
