"""Compile warmup: first-call latency with and without the
compile-latency subsystem (``core/compilecache.py``), in the PyTorch port.

The offload pitch (Gittens et al., KDD 2018) prices the overheads
*around* the fast kernel. In the port a program is built the first time
a (chain structure x operand shape) arrives: a single op runs once at its
bucket's shapes on zeros, which loads the kernels' modules, settles
cuBLAS and grows the allocator, and a chain is captured into a CUDA graph
on static input buffers. Built on the request path, that cost lands on
the first tenant who submits the shape, and the programs die with the
engine process.

This benchmark serves the same tenant mix (odd-shaped multiply / gram /
transpose / add plus a 3-stage fused multiply chain — every shape off
the bucket grid) against two engines sharing one compile cache dir:

* **cold** — a fresh engine, bucketing on, empty cache: each first call
  builds its own program (recorded in the executable index);
* **warm restart** — a *new* engine on the same cache dir after
  ``warmup()``: the catalog is built for the bucket grid and the index
  replays every previously-served signature (the fused chain included,
  captured anew), so the same tenant mix sees ZERO request-path compiles
  (``CompileLog.bucketed_request_compiles == 0``).

Reported per mix item: cold vs warm first-call wall seconds and the
aggregate speedup; plus warmup cost (off the request path) and the
CompileLog/executable-index accounting.

Run: ``PYTHONPATH=src:. python torch_benchmarks/compile_warmup.py``
(``--device cpu`` on the CPU; ``--smoke`` asserts the zero-request-path
contract, the index replay and, on a card, the >=5x warm speedup — on the
CPU, where there is no module to load and no graph to capture, it prints
the ratio; ``--two-process`` proves the index survives a real process
boundary; ``--json PATH`` writes the machine-readable result).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from torch_benchmarks.common import header, parser, row
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.libraries import elemental

RNG = np.random.RandomState(42)

# shape-diverse tenant mix: every dimension off the pow2 bucket grid
MIX = [
    ("multiply", {"A": (37, 53), "B": (53, 29)}),
    ("gram", {"A": (100, 45)}),
    ("transpose", {"A": (77, 10)}),
    ("add", {"A": (19, 23), "B": (19, 23)}),
]
CHAIN_SHAPE = (19, 19)
CHAIN_STAGES = 3

# the buckets the mix lands in — warmup covers exactly what tenant
# traffic will ask for (a narrower warmup grid only absorbs its own
# buckets; request-path compiles on the rest still register in the
# executable index for the next warmup)
GRID = (32, 64, 128)

# the aggregate first-call speedup the smoke asserts on a card
MIN_SPEEDUP = 5.0

ARRAYS = {(routine, name): RNG.randn(*shape).astype(np.float32)
          for routine, shapes in MIX for name, shape in shapes.items()}
CHAIN_ARRAY = (RNG.randn(*CHAIN_SHAPE) / 4.0).astype(np.float32)


def _fresh(cache_dir: str, device: str) -> AlchemistContext:
    # result cache off: this benchmark prices compiles, not memoization
    engine = AlchemistEngine(device=device, cache_entries=0,
                             bucketing=True, bucket_grid=GRID,
                             compile_cache_dir=cache_dir)
    engine.load_library("elemental", elemental)
    return AlchemistContext(engine=engine)


def _first_calls(ac: AlchemistContext) -> dict[str, float]:
    """Serve every mix item once, timing each blocking first call."""
    latencies: dict[str, float] = {}
    for routine, shapes in MIX:
        handles = {k: ac.send_matrix(ARRAYS[(routine, k)], dedup=False)
                   for k in shapes}
        t0 = time.perf_counter()
        ac.call("elemental", routine, **handles)
        latencies[routine] = time.perf_counter() - t0
    # the fused-chain signature (a multi-step program of its own)
    el = ac.library("elemental")
    al = ac.send_matrix(CHAIN_ARRAY, dedup=False)
    t0 = time.perf_counter()
    ac.engine.scheduler.pause()
    x = al
    for _ in range(CHAIN_STAGES):
        x = el.multiply(A=x, B=al)
    ac.engine.scheduler.resume()
    x.result()
    latencies["chain3"] = time.perf_counter() - t0
    return latencies


def _serve(cache_dir: str, warm: bool, device: str) -> dict:
    """One engine lifetime against ``cache_dir``: optionally warm up,
    then serve the tenant mix; returns latencies + compile accounting."""
    ac = _fresh(cache_dir, device)
    engine = ac.engine
    try:
        warmup = engine.warmup(grid=GRID) if warm else None
        latencies = _first_calls(ac)
        stats = engine.compile_stats()
        return {"latencies": latencies, "warmup": warmup,
                "compile_stats": stats}
    finally:
        ac.stop()
        engine.shutdown()


def run(smoke: bool = False, json_path: str | None = None,
        device: str = "cuda") -> dict:
    header("compile warmup: cold vs warm-restart first-call latency")
    with tempfile.TemporaryDirectory(prefix="alchemist-ccache-") as cdir:
        cold = _serve(cdir, warm=False, device=device)
        warm = _serve(cdir, warm=True, device=device)

    cold_total = sum(cold["latencies"].values())
    warm_total = sum(warm["latencies"].values())
    speedup = cold_total / warm_total if warm_total else float("inf")
    for name in cold["latencies"]:
        row(f"first_call_cold_{name}", cold["latencies"][name] * 1e6)
        row(f"first_call_warm_{name}", warm["latencies"][name] * 1e6,
            f"{cold['latencies'][name] / warm['latencies'][name]:.1f}x")
    row("first_call_cold_total", cold_total * 1e6)
    row("first_call_warm_total", warm_total * 1e6, f"{speedup:.1f}x")
    row("warmup_off_request_path", warm["warmup"]["warmup_s"] * 1e6,
        f"catalog={warm['warmup']['catalog']} "
        f"replayed={warm['warmup']['replayed']}")

    cs_cold = cold["compile_stats"]
    cs_warm = warm["compile_stats"]
    results = {
        "name": "compile_warmup",
        "device": device,
        "grid": list(GRID),
        "cold_first_call_s": cold["latencies"],
        "warm_first_call_s": warm["latencies"],
        "cold_total_s": cold_total,
        "warm_total_s": warm_total,
        "speedup": speedup,
        "warmup_s": warm["warmup"]["warmup_s"],
        "warmup_catalog": warm["warmup"]["catalog"],
        "warmup_replayed": warm["warmup"]["replayed"],
        "cold_request_compiles": cs_cold["request_compiles"],
        "cold_request_compile_s": cs_cold["request_compile_s"],
        "warm_request_compiles": cs_warm["request_compiles"],
        "warm_bucketed_request_compiles":
            cs_warm["bucketed_request_compiles"],
        "warm_compile_hit_rate": cs_warm["hit_rate"],
        "executable_index": cs_warm["executable_index"],
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2)
        print(f"# wrote {json_path}")

    if smoke:
        # the cold engine really did pay per-signature compiles...
        assert cs_cold["request_compiles"] >= len(MIX) + 1, cs_cold
        # ...the warm restart replayed them from the index...
        assert warm["warmup"]["replayed"] >= len(MIX) + 1, warm["warmup"]
        # ...and then absorbed the whole mix: zero request-path compiles
        # for bucketed shapes after warmup (the CompileLog contract)
        assert cs_warm["request_compiles"] == 0, cs_warm
        assert cs_warm["bucketed_request_compiles"] == 0, cs_warm
        print("# smoke OK: warm-restart absorbed the tenant mix "
              "(zero request-path compiles)")
        if device == "cpu":
            # nothing to load or capture on the CPU: the ratio is printed,
            # not held
            print(f"# first-call speedup {speedup:.2f}x on the CPU "
                  f"(asserted >= {MIN_SPEEDUP}x on a card only)")
        else:
            # warm first calls >=5x faster than cold
            assert speedup >= MIN_SPEEDUP, (cold_total, warm_total,
                                            speedup)
            print(f"# smoke OK: {speedup:.1f}x faster first calls")
    return results


# ---------------------------------------------------------------------------
# two-process persistence round trip (the restart story, for real)
# ---------------------------------------------------------------------------
def _phase(cache_dir: str, warm: bool, device: str) -> None:
    """Subprocess body: one engine lifetime, printing its accounting."""
    out = _serve(cache_dir, warm=warm, device=device)
    summary = {
        "request_compiles": out["compile_stats"]["request_compiles"],
        "bucketed_request_compiles":
            out["compile_stats"]["bucketed_request_compiles"],
        "replayed": out["warmup"]["replayed"] if out["warmup"] else 0,
        "total_first_call_s": sum(out["latencies"].values()),
    }
    if warm:
        assert summary["request_compiles"] == 0, summary
        assert summary["replayed"] >= len(MIX) + 1, summary
    print("PHASE_RESULT " + json.dumps(summary))


def run_two_process(device: str = "cuda") -> dict:
    """Serve the mix in one process, then prove a *separate* process
    warm-restarts from the same cache dir with zero request-path
    compiles: the executable index crosses a real process boundary and
    the restarted warmup rebuilds every program it names (the in-process
    version cannot tell a rebuilt program from one left in memory)."""
    header("compile warmup: two-process persistent-cache round trip")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root,
         env.get("PYTHONPATH", "")]).rstrip(os.pathsep)

    def spawn(phase: str, cdir: str) -> dict:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             f"--{phase}", cdir, "--device", device],
            capture_output=True, text=True, env=env, cwd=root,
            timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{phase} subprocess failed:\n{proc.stdout}\n{proc.stderr}")
        for line in proc.stdout.splitlines():
            if line.startswith("PHASE_RESULT "):
                return json.loads(line[len("PHASE_RESULT "):])
        raise RuntimeError(f"{phase} printed no PHASE_RESULT:\n"
                           f"{proc.stdout}")

    with tempfile.TemporaryDirectory(prefix="alchemist-ccache2p-") as cdir:
        first = spawn("persist-phase1", cdir)
        second = spawn("persist-phase2", cdir)
    row("two_process_cold_total", first["total_first_call_s"] * 1e6)
    row("two_process_warm_total", second["total_first_call_s"] * 1e6,
        f"replayed={second['replayed']}")
    assert first["request_compiles"] >= len(MIX) + 1, first
    assert second["request_compiles"] == 0, second
    print("# two-process OK: the restarted process rebuilt the indexed "
          "programs in warmup and compiled nothing on the request path")
    return {"first": first, "second": second}


def main() -> None:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="write machine-readable results to PATH")
    ap.add_argument("--two-process", action="store_true",
                    help="run the cross-process persistence round trip")
    ap.add_argument("--persist-phase1", metavar="DIR",
                    help=argparse.SUPPRESS)      # subprocess entry
    ap.add_argument("--persist-phase2", metavar="DIR",
                    help=argparse.SUPPRESS)      # subprocess entry
    args = ap.parse_args()
    if args.persist_phase1:
        _phase(args.persist_phase1, warm=False, device=args.device)
        return
    if args.persist_phase2:
        _phase(args.persist_phase2, warm=True, device=args.device)
        return
    if args.two_process:
        run_two_process(args.device)
        return
    print("name,us_per_call,derived")
    run(smoke=args.smoke, json_path=args.json, device=args.device)


if __name__ == "__main__":
    main()
