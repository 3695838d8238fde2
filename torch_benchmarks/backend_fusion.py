"""Backend fusion: one program per chain vs one task per op, in the
PyTorch port.

The lazy client already submits an N-op chain in one burst (one
``submit`` crossing per stage, zero intermediate round trips). The
backend ABI finishes the job engine-side: when a worker picks up the
chain's head, the engine claims the whole fusible chain from the
scheduler and the torch backend runs it as **one program** — on a card
one CUDA graph, captured once and replayed — one task instead of N, with
chain-internal values never materialized between steps
(``engine._run_fused``).

This benchmark builds an N-stage ``multiply`` chain three ways on
identical engines and reports, per N:

* measured client wall seconds (second run of each mode, so programs
  are built and captures made before the timed run): **eager**
  (blocking ``call`` per op, the pre-façade idiom), **unfused burst**
  (lazy chain with fusion disabled), **fused burst** (the default);
* tasks dispatched vs commands absorbed (``engine.task_log.stats()``) —
  the fused chain must dispatch exactly ONE task;
* modeled cluster-scale chain overhead: protocol crossings priced at the
  Table-3 per-message latency (both directions) plus dispatches priced
  at ``costmodel.TASK_DISPATCH_S`` — the fixed cost fusion amortizes;

plus a per-routine **torch vs reference** execution table (same inputs,
both backends through the ABI).

Run: ``PYTHONPATH=src:. python torch_benchmarks/backend_fusion.py``
(``--device cpu`` on the CPU; ``--smoke`` for the CI-sized run, which
asserts the one-task contract and the modeled win).
"""
from __future__ import annotations

import inspect
import time

import numpy as np

from torch_benchmarks.common import header, parser
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.costmodel import CHUNK_LATENCY_S, TASK_DISPATCH_S
from repro_torch.core.libraries import elemental, skylark

ROUND_TRIP_S = 2 * CHUNK_LATENCY_S
DIM = 128


def _fresh(device: str, backend="torch", fusion=True) -> AlchemistContext:
    # cache off: every mode must recompute
    engine = AlchemistEngine(device=device, cache_entries=0)
    engine.load_library("elemental", elemental)
    engine.load_library("skylark", skylark)
    return AlchemistContext(engine=engine, backend=backend, fusion=fusion)


def _chain(ac: AlchemistContext, al, stages: int, burst: bool):
    """Build + force one multiply chain; returns (wall_s, task-stats
    delta, endpoint delta, result array)."""
    engine = ac.engine
    el = ac.library("elemental")
    stats0 = engine.task_log.stats()
    counts0 = dict(engine.endpoint_counts)
    t0 = time.perf_counter()
    if burst:
        engine.scheduler.pause()
    x = al
    for _ in range(stages):
        if burst:
            x = el.multiply(A=x, B=al)
        else:
            x = ac.wrap(ac.call("elemental", "multiply", A=x, B=al)["C"])
    if burst:
        engine.scheduler.resume()
        x.result()
    wall = time.perf_counter() - t0
    stats1 = engine.task_log.stats()
    delta = {k: stats1[k] - stats0[k]
             for k in ("dispatched", "absorbed", "commands")}
    counts = {k: engine.endpoint_counts[k] - counts0.get(k, 0)
              for k in ("submit", "task_op")}
    return wall, delta, counts, x


def modeled_chain_overhead_s(crossings: int, dispatches: int) -> float:
    """Cluster-scale fixed cost of driving one chain: every protocol
    crossing is a client<->engine message pair at the Table-3 calibrated
    per-message latency, every dispatched task pays the scheduler +
    launch overhead fusion amortizes."""
    return crossings * ROUND_TRIP_S + dispatches * TASK_DISPATCH_S


MODES = (("eager", False, None),          # blocking call() per op
         ("burst", True, False),          # lazy burst, fusion off
         ("fused", True, None))           # lazy burst, fusion on


def run(stage_sweep, device: str, smoke: bool = False) -> None:
    header("backend fusion: one program per chain vs one task/op")
    print(f"{DIM}x{DIM} multiply chains on {device}; modeled: "
          f"{ROUND_TRIP_S * 1e3:.2f}ms/crossing + "
          f"{TASK_DISPATCH_S * 1e3:.2f}ms/dispatch")
    rng = np.random.RandomState(0)
    a = (rng.randn(DIM, DIM) / np.sqrt(DIM)).astype(np.float32)

    print("stages,mode,wall_s,tasks,absorbed,crossings,modeled_s")
    for stages in stage_sweep:
        results = {}
        for mode, burst, fusion in MODES:
            ac = _fresh(device,
                        fusion=fusion if fusion is not None else True)
            al = ac.send_matrix(a)
            _chain(ac, al, stages, burst)                 # build programs
            wall, delta, counts, x = _chain(ac, al, stages, burst)
            crossings = counts["submit"] + counts["task_op"]
            modeled = modeled_chain_overhead_s(crossings,
                                               delta["dispatched"])
            results[mode] = (wall, delta, counts, modeled,
                             x.to_numpy())
            print(f"{stages},{mode},{wall:.4f},{delta['dispatched']},"
                  f"{delta['absorbed']},{crossings},{modeled:.4f}")
            ac.stop()
            ac.engine.shutdown()

        wall_e, delta_e, counts_e, modeled_e, out_e = results["eager"]
        wall_f, delta_f, counts_f, modeled_f, out_f = results["fused"]
        # all three modes compute the same chain
        np.testing.assert_allclose(out_f, out_e, rtol=1e-3, atol=1e-5)
        # the fused contract: ONE dispatched task for the whole chain,
        # every other command absorbed into it, zero extra crossings
        assert delta_f["dispatched"] == 1, delta_f
        assert delta_f["absorbed"] == stages - 1, delta_f
        assert counts_f == {"submit": stages, "task_op": 1}, counts_f
        assert delta_e["dispatched"] == stages, delta_e
        # and the modeled fixed cost strictly shrinks
        assert modeled_f < modeled_e, (modeled_f, modeled_e)
        print(f"{stages},saved,,,,,"
              f"{modeled_e - modeled_f:.4f}")


ROUTINE_TABLE = (
    ("elemental", "multiply", lambda a: {"A": a, "B": a}, {}),
    ("elemental", "add", lambda a: {"A": a, "B": a}, {}),
    ("elemental", "transpose", lambda a: {"A": a}, {}),
    ("elemental", "gram", lambda a: {"A": a}, {}),
    ("elemental", "qr", lambda a: {"A": a}, {}),
    ("elemental", "gram_svd", lambda a: {"A": a}, {"k": 8}),
    ("elemental", "truncated_svd", lambda a: {"A": a}, {"k": 8}),
    ("elemental", "randomized_svd", lambda a: {"A": a}, {"k": 8}),
    ("skylark", "cg_solve", lambda a: {"X": a},
     {"lam": 1e-3, "max_iters": 50}),
)


def run_routine_table(device: str, dim: int = 192, limit: int = 0) -> None:
    """Per-routine torch vs reference wall time through the ABI. The
    input is square (multiply/add/gram all accept it) with a
    well-separated spectrum (stable SVD-family comparisons)."""
    header("per-routine backend comparison (same inputs, both backends)")
    rng = np.random.RandomState(1)
    a = (rng.randn(dim, dim) @ np.diag(
        np.geomspace(4.0, 0.1, dim))).astype(np.float32)
    y = rng.randn(dim, 2).astype(np.float32)
    table = ROUTINE_TABLE[:limit] if limit else ROUTINE_TABLE

    print("library.routine,torch_ms,reference_ms,torch_speedup")
    for library, routine, arrays, scalars in table:
        walls = {}
        for backend in ("torch", "reference"):
            ac = _fresh(device, backend=backend)
            kwargs = {k: ac.send_matrix(v)
                      for k, v in arrays(a).items()}
            if "Y" in _params(library, routine):
                kwargs["Y"] = ac.send_matrix(y)
            ac.call(library, routine, **kwargs, **scalars)   # warm
            t0 = time.perf_counter()
            ac.call(library, routine, **kwargs, **scalars)
            walls[backend] = time.perf_counter() - t0
            ac.stop()
            ac.engine.shutdown()
        speedup = walls["reference"] / max(walls["torch"], 1e-9)
        print(f"{library}.{routine},{walls['torch'] * 1e3:.2f},"
              f"{walls['reference'] * 1e3:.2f},{speedup:.2f}")


def _params(library: str, routine: str) -> set:
    module = {"elemental": elemental, "skylark": skylark}[library]
    return set(inspect.signature(module.ROUTINES[routine]).parameters)


def main() -> None:
    p = parser(__doc__)
    p.add_argument("--stages", default="4,16,64",
                   help="comma-separated chain lengths")
    args = p.parse_args()
    if args.smoke:
        run([4], args.device, smoke=True)
        run_routine_table(args.device, dim=64, limit=4)
        print("backend_fusion --smoke OK: fused chain = 1 dispatched "
              "task, zero intermediate crossings, modeled overhead < "
              "eager per-op")
    else:
        run([int(s) for s in args.stages.split(",")], args.device)
        run_routine_table(args.device)


if __name__ == "__main__":
    main()
