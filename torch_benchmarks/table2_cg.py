"""Paper Table 2: per-iteration CG cost, Spark vs Alchemist, with the
PyTorch port as the engine.

Measured: both implementations run the identical CG (same math, same
iteration count) at CPU scale — the Spark path over row partitions with a
BSP round per iteration, the Alchemist path as engine matvecs (the port's normal_matvec kernel on a
card).
Modeled: the Table-2 calibration projects both to 20/30/40 Cori nodes; the
paper's measured numbers are printed alongside for the reproduction check.

Run: ``PYTHONPATH=src:. python torch_benchmarks/table2_cg.py``
(``--device cpu`` on the CPU; ``--smoke`` at 2,000 x 64 x 4).
"""
from __future__ import annotations

import numpy as np

from torch_benchmarks.common import header, parser, row, timeit
from repro_torch.core import AlchemistContext
from repro_torch.core.costmodel import (
    alchemist_cg_iteration_seconds,
    spark_cg_iteration_seconds,
)
from repro_torch.core.libraries import mllib, skylark
from repro_torch.frontend.rowmatrix import RowMatrix

PAPER = {  # nodes -> (spark iter s, alchemist iter s)
    20: (75.3, 2.5),
    30: (55.9, 1.5),
    40: (40.6, 1.2),
}

N, D, C = 20_000, 1_024, 16     # CPU-scale stand-in for 2.25M x 10k x 147
SMOKE = (2_000, 64, 4)


def run(device: str = "cuda", smoke: bool = False) -> None:
    header("Table 2: CG per-iteration cost (Spark vs Alchemist)")
    n, d, c = SMOKE if smoke else (N, D, C)
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, c).astype(np.float32)

    # --- measured: alchemist engine path ---
    ac = AlchemistContext(num_workers=1, device=device)
    ac.register_library("skylark", skylark)
    al_x, al_y = ac.send_matrix(x), ac.send_matrix(y)

    iters_holder = {}

    def alch():
        res = ac.call("skylark", "cg_solve", X=al_x, Y=al_y, lam=1e-5,
                      max_iters=30, tol=0.0)
        iters_holder["n"] = res["iterations"]

    t_alch = timeit(alch, warmup=1, iters=3) / 30

    # --- measured: spark (BSP over row partitions) path ---
    xm = RowMatrix.from_array(x, 16)
    ym = RowMatrix.from_array(y, 16)

    def spark():
        mllib.spark_cg_solve(xm, ym, lam=1e-5, max_iters=30, tol=0.0)

    t_spark = timeit(spark, warmup=1, iters=2) / 30

    row("table2/measured_alchemist_iter", t_alch * 1e6,
        f"n={n} d={d} c={c} device={device}")
    row("table2/measured_spark_iter", t_spark * 1e6,
        f"layout_overhead_x={t_spark / t_alch:.2f}")

    # --- modeled cluster scale vs paper ---
    for nodes, (p_spark, p_alch) in PAPER.items():
        m_spark = spark_cg_iteration_seconds(nodes, 2_251_569, 10_000)
        m_alch = alchemist_cg_iteration_seconds(nodes, 2_251_569, 10_000)
        row(f"table2/modeled_spark_{nodes}n", m_spark * 1e6,
            f"paper={p_spark}s model={m_spark:.1f}s "
            f"err={abs(m_spark - p_spark) / p_spark:.1%}")
        row(f"table2/modeled_alchemist_{nodes}n", m_alch * 1e6,
            f"paper={p_alch}s model={m_alch:.2f}s "
            f"err={abs(m_alch - p_alch) / p_alch:.1%}")
        row(f"table2/speedup_{nodes}n", 0.0,
            f"paper={p_spark / p_alch:.1f}x model={m_spark / m_alch:.1f}x")


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0]).parse_args()
    run(args.device, args.smoke)
