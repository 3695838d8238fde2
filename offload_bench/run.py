"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell of ``BENCHMARK.json`` on the machine it starts on.

    python3 offload_bench/run.py --workload timit_cg.solve --seed 7 \\
        --seconds 30 --trace 0

(or ``python3 -m offload_bench.run ...``)

from the root of a checkout. It makes its inputs from ``--seed`` on the
card, warms up, measures for ``--seconds``, runs one more job of the
same kind once the window has closed and judges it against a plain
float64 reference and prints one JSON object as the last
line of standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics from a profiled window), and each
number judged beside its limit as the last lines of standard error. It
exits non-zero with no result without enough CUDA cards, without the
port's package beside it, or when the process holds JAX or the JAX
package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".offload_bench_cache"
# run as a script, Python puts this directory first on the path, where
# its modules would shadow the standard library's (trace): put the
# package's root there instead
if sys.path and Path(sys.path[0]).resolve() == ROOT / "offload_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m offload_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_environment() -> None:
    """Kernel caches at fixed paths inside the checkout, and the port's
    sources on the path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        _err(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _err(f"{args.workload} needs {chips} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        _err(f"the port's package (src/repro_torch) is not in this checkout: "
             f"{e}")
        return 2
    from offload_bench import harness
    cell = harness.load_cell(bench, args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START, log=_err)
    found = harness.forbidden_modules()
    if found:
        _err("the process holds " + ", ".join(found) + " after the window: "
             "the benchmark measures the PyTorch port alone")
        return 3
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
