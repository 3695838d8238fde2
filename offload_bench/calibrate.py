"""The readings the limits of ``limits/<cell>.json`` are set from: every
number a cell's judge computes, for the system on each of ``--seeds``
(set-up and warm-up as in a run, then the judged job that follows the
window, with its spies), for the control on each of ``--control-seeds``
(the plain reference in the system's place with TF32 products,
``configs/*.py`` ``control``) and for a planted fault on each of
``--fault-seeds``, all in one process at the cell's own size. The
benchmark's runs do not run this.

    python3 offload_bench/calibrate.py --workload ocean_svd.gram \\
        --seeds 1,2,3 --control-seeds 4,5,6 \\
        [--fault half_batch --fault-seeds 7,8,9] [--out readings.jsonl]

Prints one JSON line a reading, and appends them to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "offload_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from offload_bench import harness, run as run_mod  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def program_reading(cell, seed: int, device) -> dict:
    result, answer, args = harness.measure(
        cell, seed, 0.0, False, device, time.perf_counter(),
        log=lambda *_: None)
    t0 = time.perf_counter()
    numbers = harness.config_module(cell).judge(
        cell.config, cell.traffic, args, seed, answer, device)
    return {"numbers": numbers, "judge_s": time.perf_counter() - t0,
            "failed": result["failed"] + bool(answer.get("error"))}


def control_reading(cell, seed: int, device, fault=None) -> dict:
    import torch
    from offload_bench.loops.closed_loop import resolve_args
    ref = harness.config_module(cell)
    args = resolve_args(cell.traffic, cell.config, seed)
    answer = ref.control(cell.config, cell.traffic, args, seed, device,
                         fault=fault)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"numbers": ref.judge(cell.config, cell.traffic, args, seed,
                                 answer, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="offload_bench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="",
                   help="also read this planted fault (configs/*.py control)")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    run_mod.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    def fault_reading(cell, seed, device):
        return control_reading(cell, seed, device, fault=args.fault)

    for side, seeds, fn in (("program", _seeds(args.seeds), program_reading),
                            ("control", _seeds(args.control_seeds),
                             control_reading),
                            (f"fault:{args.fault}", _seeds(args.fault_seeds),
                             fault_reading)):
        for seed in seeds:
            t0 = time.perf_counter()
            rec = {"cell": cell.name, "side": side, "seed": seed,
                   **fn(cell, seed, "cuda"),
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
