"""Shared benchmark utilities (a copy of ``benchmarks/common.py`` for the
PyTorch port's benchmarks), plus the ``--device`` option they share."""
from __future__ import annotations

import argparse
import time

import numpy as np


def timeit(fn, *, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def row(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def header(title: str) -> None:
    print(f"\n# === {title} ===")


def parser(description: str, smoke: bool = True) -> argparse.ArgumentParser:
    """``--device`` (the engine's device: ``cuda`` by default, which fails
    where CUDA is absent; ``cpu`` where asked) and, where the script has
    one, ``--smoke`` (its smallest size)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda)")
    if smoke:
        ap.add_argument("--smoke", action="store_true",
                        help="the smallest size, for a quick check")
    return ap
