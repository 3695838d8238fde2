"""Drive the port's engine under the lock tracer and the lifecycle monitor:
the dynamic half of the invariant gate.

    REPRO_LOCK_TRACE=1 REPRO_LOCK_TRACE_OUT=locks.json REPRO_STM_TRACE=1 \\
        python -m repro_torch.analysis.tracedrive --device cuda
    python -m repro_torch.analysis --check-lock-report locks.json

Both switches are read when a lock or an engine is built (module-level
locks at import), so they must be set in the environment the process
starts with; it refuses to run without them. One engine with two
scheduler workers serves, at once:

* two in-memory clients and one client over the port's TCP server
  (``repro_torch.core.server``), each sending burst chains
  ``G = gram(((A B + A)^T) B)`` at a few square sizes (``gram`` launches
  the port's gram kernel on a card). An in-memory burst is
  submitted with the scheduler paused, so it fuses into one task; on a
  card a chain is captured into a CUDA graph when it is first compiled and
  replayed after, by all three clients, which share its program;
* ``warmup`` on a thread of its own, compiling the catalog's single ops
  beside the requests;

with a program LRU small enough, in count and in bytes, that programs
are evicted while others replay them, and a store budget small enough
that stores spill to the host and reload through ``_resolve``. Each
chain's result is held against numpy. Then one client spills and
reloads a store on purpose, so the run shows both whatever the
interleaving.

It prints one JSON line (evictions, spills, reloads, programs, capture
failures, kernel launches, the longest lock holds, monitor violations)
and exits non-zero on a wrong result, a monitor violation, a failed
capture, or a run without an eviction, a spill or a reload. The lock
report goes to ``REPRO_LOCK_TRACE_OUT`` at exit (``locktrace``).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
from collections import Counter
from typing import Any, Optional

import numpy as np

from repro_torch.analysis import locktrace, statemachine

#: square chain sizes (exact bucket shapes, so nothing pads)
SIZES = (64, 128, 256)
#: program LRU: three programs, and on a card fewer bytes than two of the
#: largest chain's programs hold (each pins two 256 x 256 inputs and four
#: outputs, 1.5 MiB)
MAX_PROGRAMS = 3
MAX_PROGRAM_BYTES = 2 << 20
#: the store budget: four of the largest operands
STORE_BUDGET_BYTES = 4 * 256 * 256 * 4
#: tolerance of a chain against numpy, times max |want|
RTOL = 1e-4


class _CountingTrace(statemachine.StmTrace):
    """The lifecycle monitor, also counting transitions by (machine,
    destination, site)."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: Counter = Counter()
        self._count_mu = threading.Lock()

    def note(self, machine: str, key: Any, dst: str, *,
             site: str) -> None:
        with self._count_mu:
            self.counts[(machine, dst, site)] += 1
        super().note(machine, key, dst, site=site)


def _chain_want(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    c = (a64 @ b64 + a64).T @ b64
    return c.T @ c


def _burst(ac, a, b, engine=None):
    """Submit ``gram(((A B + A)^T) B)`` lazily; with ``engine``
    (in-memory) the scheduler is paused around the burst so the chain
    fuses whole."""
    el = ac.library("elemental")
    al_a, al_b = ac.send_matrix(a), ac.send_matrix(b)
    if engine is not None:
        engine.scheduler.pause()
    try:
        c = el.multiply(A=el.transpose(A=el.add(
            A=el.multiply(A=al_a, B=al_b), B=al_a)), B=al_b)
        g = el.gram(A=c)
    finally:
        if engine is not None:
            engine.scheduler.resume()
    return g


def _client(ac, seed: int, rounds: int, engine, errors: list) -> None:
    rng = np.random.default_rng(seed)
    try:
        for r in range(rounds):
            n = SIZES[(seed + r) % len(SIZES)]
            a = rng.standard_normal((n, n)).astype(np.float32)
            b = rng.standard_normal((n, n)).astype(np.float32)
            got = np.asarray(_burst(ac, a, b, engine).to_numpy(),
                             np.float64)
            want = _chain_want(a, b)
            err = float(np.max(np.abs(got - want)))
            if err > RTOL * float(np.max(np.abs(want))):
                raise AssertionError(
                    f"chain at n={n}: max |error| {err:.3e}")
    except Exception as e:  # reported in the summary's errors
        errors.append(f"client {seed}: {type(e).__name__}: {e}")


def _longest_holds(n: int) -> list[dict]:
    """The ``n`` longest single holds of traced locks (condition variables
    excluded: waiting is their job), whatever their length; the report's
    ``long_holds`` lists only those past ``locktrace.LONG_HOLD_S``."""
    tr = locktrace.TRACE
    rows = [(name, row) for name, row in list(tr.holds.items())
            if name not in tr.cv_names]
    rows.sort(key=lambda kv: -kv[1]["max_s"])
    return [{"name": name, "max_ms": row["max_s"] * 1e3,
             "count": row["count"], "site": row["site"]}
            for name, row in rows[:n]]


def drive(device="cuda", rounds: int = 12, warmup_grid=(256, 1024)
          ) -> dict:
    """Run the traced workload (see the module's docstring) on
    ``device``; returns the summary the CLI prints."""
    from repro_torch.common.device import explicit_device
    dev = explicit_device(device, "tracedrive")
    trace = _CountingTrace()
    armed, statemachine.TRACE = statemachine.TRACE, trace
    try:
        return _drive(dev, trace, rounds, warmup_grid)
    finally:
        statemachine.TRACE = armed


def _drive(dev, trace: _CountingTrace, rounds: int, warmup_grid) -> dict:
    from repro_torch.core import AlchemistContext, AlchemistEngine
    from repro_torch.core.libraries import elemental
    from repro_torch.core.server import AlchemistServer
    from repro_torch.kernels import launch_counters

    counters = launch_counters()
    for c in counters.values():
        c.reset()
    engine = AlchemistEngine(device=dev, scheduler_workers=2,
                             cache_entries=0,
                             program_cache_size=MAX_PROGRAMS,
                             memory_budget_bytes=STORE_BUDGET_BYTES)
    engine.load_library("elemental", elemental)
    backend = engine.backends["torch"]
    backend.max_program_bytes = MAX_PROGRAM_BYTES
    server = AlchemistServer(engine=engine).start()
    errors: list[str] = []
    clients = [AlchemistContext(engine=engine, client_name=f"mem{i}",
                                device=dev) for i in range(2)]
    clients.append(AlchemistContext(address=server.address,
                                    client_name="tcp"))
    try:
        threads = [threading.Thread(
            target=_client, args=(ac, i, rounds,
                                  None if i == 2 else engine, errors))
            for i, ac in enumerate(clients)]
        warm: dict = {}
        threads.append(threading.Thread(target=lambda: warm.update(
            engine.warmup(grid=warmup_grid))))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # a spill and a reload on purpose: fill the budget past the first
        # store, then read it back
        ac = clients[0]
        rng = np.random.default_rng(99)
        first = rng.standard_normal((256, 256)).astype(np.float32)
        al_first = ac.send_matrix(first)
        extra = [ac.send_matrix(rng.standard_normal(
            (256, 256)).astype(np.float32)) for _ in range(4)]
        spilled = engine.is_spilled(al_first.handle)
        back = ac.fetch(al_first.handle).collect()
        reloaded = not engine.is_spilled(al_first.handle)
        if not (spilled and reloaded and np.array_equal(back, first)):
            errors.append(f"spill and reload: spilled {spilled}, "
                          f"reloaded {reloaded}")
        del extra
        info = backend.program_cache_info()
        graphs = backend.graphs()
    finally:
        for ac in clients:
            ac.stop()
        server.stop()
        engine.shutdown()
    counts = trace.counts
    summary = {
        "device": str(dev),
        "evictions": info["evictions"],
        "programs": info["programs"],
        "held_bytes": info["held_bytes"],
        "max_program_bytes": info["max_program_bytes"],
        "graphs_at_end": graphs,
        "capture_failures": backend.capture_failures,
        "spills": counts[("store", "SPILLED", "_enforce_budget")],
        "reloads": counts[("store", "LIVE", "_resolve")],
        "warmup_compiled": warm.get("compiled", 0),
        "launches": {n: c.value for n, c in counters.items()},
        "longest_holds": _longest_holds(3),
        "transitions": trace.report()["transitions"],
        "violations": trace.violations(),
        "errors": errors,
    }
    return summary


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracedrive",
        description="Drive the engine under the lock tracer and the "
                    "lifecycle monitor (the gate's dynamic half)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--rounds", type=int, default=12,
                    help="burst chains per client")
    ap.add_argument("--warmup-grid", default="256,1024",
                    help="bucket grid the warmup thread compiles")
    args = ap.parse_args(argv)
    if not (locktrace.enabled() and statemachine.enabled()):
        print(f"tracedrive: set {locktrace.ENV_FLAG}=1 and "
              f"{statemachine.ENV_FLAG}=1 in the environment the process "
              "starts with", file=sys.stderr)
        return 2
    grid = tuple(int(g) for g in args.warmup_grid.split(",") if g)
    summary = drive(args.device, rounds=args.rounds, warmup_grid=grid)
    print(json.dumps(summary), flush=True)
    ok = (not summary["errors"] and not summary["violations"]
          and summary["capture_failures"] == 0
          and summary["evictions"] > 0 and summary["spills"] > 0
          and summary["reloads"] > 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
