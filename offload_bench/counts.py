"""Operations and bytes of the kernels and of whole jobs, from shapes, and
the least time the card could take for them (the benchmark's own copy:
the peaks come from ``peaks.json``, not from the system).

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again. fp32 operations are held against the TF32
tensor-core rate, which no route that keeps fp32 accuracy can pass
(3xTF32 runs three products for each, so it caps at a third of it).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
FP32 = 4


def normal_matvec(n: int, d: int, c: int, itemsize: int = FP32):
    """w -> X^T (X w), X (n, d), w (d, c): (operations, bytes)."""
    return 4 * n * d * c, n * d * itemsize + 2 * d * c * FP32


def rf_map(n: int, d: int, big_d: int, itemsize: int = FP32):
    """Z = sqrt(2/D) cos(X W + b), X (n, d), W (d, D): (operations,
    bytes)."""
    return 2 * n * d * big_d, (n * d * itemsize + d * big_d * FP32
                               + big_d * FP32 + n * big_d * FP32)


def gram(n: int, d: int, itemsize: int = FP32):
    """G = A^T A of A (n, d), the symmetric half: (operations, bytes)."""
    return n * d * (d + 1), n * d * itemsize + d * d * FP32


def least_seconds(ops: float, nbytes: float, peaks: dict = PEAKS) -> float:
    """The larger of operations over the TF32 peak and bytes over HBM."""
    return max(ops / peaks["tf32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def job_ops(routine: str, cfg: dict, args: dict):
    """Operations the algorithm of one job needs, or None where bytes
    bound it. CG: the expansion, b = Z^T Y and one product an iteration;
    gram_svd: the Gram matrix and U = X V (eigh not counted, which only
    lowers the share)."""
    n = cfg["rows"]
    if routine == "cg_solve":
        d, big_d, c = cfg["d"], int(args["rf_dim"]), cfg["classes"]
        return (rf_map(n, d, big_d)[0] + 2 * n * big_d * c
                + int(args["max_iters"]) * normal_matvec(n, big_d, c)[0])
    if routine == "gram_svd":
        d, k = cfg["d"], int(args["k"])
        return gram(n, d)[0] + 2 * n * d * k
    return None


def job_bytes(routine: str, cfg: dict, args: dict):
    """Bytes the algorithm of one job must move, where they bound it, or
    None. truncated_svd: X read once a Lanczos step (k + oversample
    steps) and once more for U = X V."""
    if routine == "truncated_svd":
        steps = min(cfg["d"], int(args["k"]) + int(args["oversample"]))
        return (steps + 1) * cfg["rows"] * cfg["d"] * FP32
    return None
