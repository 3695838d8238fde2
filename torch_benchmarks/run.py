"""Benchmark harness of the PyTorch port — one module per paper
table/figure, under the reference's names. Prints
``name,us_per_call,derived`` CSV rows.

  PYTHONPATH=src:. python -m torch_benchmarks.run              # everything
  PYTHONPATH=src:. python -m torch_benchmarks.run table2 --device cpu
  PYTHONPATH=src:. python -m torch_benchmarks.run --json-dir out/

``--device`` is the engines' device (default cuda, which raises where
CUDA is absent). ``compile_warmup`` and ``qos_fairness`` write their
machine-readable results as ``BENCH_<name>.json`` only into the
directory ``--json-dir`` names: without it no file is written.
"""
from __future__ import annotations

import argparse
import os

from torch_benchmarks import (
    backend_fusion,
    cache_amortization,
    chain_pipelining,
    compile_warmup,
    fig3_weak_scaling,
    kernel_bench,
    multiclient_throughput,
    roofline_table,
    table2_cg,
    table3_transfer,
    table4_cg_features,
    table5_svd,
)


def _json(json_dir, name):
    if not json_dir:
        return None
    os.makedirs(json_dir, exist_ok=True)
    return os.path.join(json_dir, f"BENCH_{name}.json")


# name -> run(device, json_dir)
ALL = {
    "table2": lambda dev, _: table2_cg.run(dev),
    "table3": lambda dev, _: table3_transfer.run(dev),
    "table4": lambda dev, _: table4_cg_features.run(dev),
    "table5": lambda dev, _: table5_svd.run(dev),
    "fig3": lambda dev, _: fig3_weak_scaling.run(dev),
    "kernels": lambda dev, _: kernel_bench.run(dev),
    "roofline": lambda dev, _: roofline_table.run(dev),
    # smoke-sized here; the standalone script exposes the full sweep
    "multiclient": lambda dev, _: multiclient_throughput.run(
        [1, 2, 4], duration_s=2.0, k=8, workers=2, device=dev),
    # the same tenant mix over real TCP (core/server.py + SocketBridge)
    "multiclient_socket": lambda dev, _: multiclient_throughput.run(
        [1, 2, 4], duration_s=2.0, k=8, workers=2, bridge="socket",
        device=dev),
    "cache": lambda dev, _: cache_amortization.run(
        3, (512, 128), k=8, smoke=False, device=dev),
    "cache_socket": lambda dev, _: cache_amortization.run(
        3, (512, 128), k=8, smoke=False, bridge="socket", device=dev),
    "chain": lambda dev, _: chain_pipelining.run([4, 16, 64], device=dev),
    # smoke-sized here; the standalone script exposes the full sweep
    "fusion": lambda dev, _: (backend_fusion.run([4, 16], dev),
                              backend_fusion.run_routine_table(dev,
                                                               dim=96)),
    # machine-readable output, written where --json-dir names a place
    "compile_warmup": lambda dev, out: compile_warmup.run(
        json_path=_json(out, "compile_warmup"), device=dev),
    # multi-tenant QoS: light-tenant p99 vs solo baseline, asserted
    "qos_fairness": lambda dev, out: multiclient_throughput.run_qos(
        duration_s=2.0, k=8, workers=2, smoke=True,
        json_path=_json(out, "qos_fairness"), device=dev),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="*",
                    help=f"benchmarks to run (default all: {', '.join(ALL)})")
    ap.add_argument("--device", default="cuda",
                    help="the engines' device (default cuda)")
    ap.add_argument("--json-dir", default=None,
                    help="write BENCH_<name>.json files here")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.which) - set(ALL))
    if unknown:
        ap.error(f"unknown benchmark(s): {', '.join(unknown)}")
    print("name,us_per_call,derived")
    for name in args.which or list(ALL):
        ALL[name](args.device, args.json_dir)


if __name__ == "__main__":
    main()
