"""Paper Table 4: Alchemist CG cost vs number of random features, with
the PyTorch port as the engine.

The paper's point: per-iteration cost grows linearly in the feature count
(10k..60k features, engine-side expansion). By default we measure the same
sweep at CPU scale (rf_dim 512..4096, engine-side expansion through the
rf_map op; on a card the rf_map kernel once a solve, then the
normal_matvec kernel at every iteration) and check the linearity; the
modeled 30-node numbers are printed against the paper's. ``run()`` takes
the rows, width, classes and feature list, so the sweep also runs at the
paper's feature counts on a card.

Run: ``PYTHONPATH=src:. python torch_benchmarks/table4_cg_features.py``
(``--device cpu`` on the CPU; ``--smoke`` at 2,048 rows and 128..1,024
features).
"""
from __future__ import annotations

import numpy as np

from torch_benchmarks.common import header, parser, row, timeit
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.costmodel import alchemist_cg_iteration_seconds
from repro_torch.core.libraries import skylark

PAPER = {  # features -> (iter ms, total s) at 30 nodes
    10_000: (1490.6, 788.5), 20_000: (2895.8, 1534.8),
    30_000: (4317.0, 2270.7), 40_000: (5890.4, 3104.2),
    50_000: (7286.9, 3854.8), 60_000: (8794.9, 4643.7),
}
# the paper's TIMIT rows, which the modeled rows price
PAPER_ROWS = 2_251_569
PAPER_NODES = 30

N, D, C = 8_192, 440, 16
FEATURES = (512, 1024, 2048, 4096)
SMOKE = (2_048, (128, 256, 512, 1024))
ITERS = 20


def modeled_iteration_seconds() -> dict[int, float]:
    """The cost model's per-iteration seconds at the paper's 30 nodes and
    rows, for each of the paper's feature counts."""
    return {feats: alchemist_cg_iteration_seconds(PAPER_NODES, PAPER_ROWS,
                                                  feats)
            for feats in PAPER}


def run(device: str = "cuda", smoke: bool = False, rows: int = N,
        d: int = D, c: int = C, features=FEATURES,
        iters: int = ITERS) -> dict:
    """The measured sweep and the modeled rows. Returns {"measured":
    {features: seconds an iteration}, "linearity_ratio": t(last) /
    t(first), "solves": CG solves run per feature count, "iterations":
    iterations a solve}."""
    header("Table 4: CG cost vs feature count (engine-side expansion)")
    if smoke:
        rows, features = SMOKE
    rng = np.random.RandomState(0)
    x = rng.randn(rows, d).astype(np.float32)
    y = rng.randn(rows, c).astype(np.float32)
    # result cache off: every timed solve must compute
    engine = AlchemistEngine(device=device, cache_entries=0)
    ac = AlchemistContext(engine=engine)
    ac.register_library("skylark", skylark)
    al_x = ac.send_matrix(x, dedup=False)
    al_y = ac.send_matrix(y, dedup=False)

    measured = {}
    warmup, reps = 1, 2
    try:
        for rf in features:
            outs = []

            def call():
                outs.append(ac.call("skylark", "cg_solve", X=al_x, Y=al_y,
                                    lam=1e-5, rf_dim=rf, max_iters=iters,
                                    tol=0.0)["W"])

            t = timeit(call, warmup=warmup, iters=reps) / iters
            for w in outs:
                ac.wrap(w).free()
            measured[rf] = t
            row(f"table4/measured_iter_rf{rf}", t * 1e6,
                f"n={rows} d={d} c={c} device={device}")
    finally:
        ac.stop()
        engine.shutdown()
    # linearity check: matvec-dominated work grows with the features
    first, last = features[0], features[-1]
    ratio = measured[last] / measured[first]
    row("table4/linearity_ratio", 0.0,
        f"t({last})/t({first})={ratio:.1f} (ideal {last / first:.1f})")

    for feats, m in modeled_iteration_seconds().items():
        p_iter_ms = PAPER[feats][0]
        row(f"table4/modeled_iter_{feats // 1000}k", m * 1e6,
            f"paper={p_iter_ms}ms model={m * 1e3:.0f}ms "
            f"err={abs(m * 1e3 - p_iter_ms) / p_iter_ms:.0%}")
    return {"measured": measured, "linearity_ratio": ratio,
            "solves": warmup + reps, "iterations": iters}


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0]).parse_args()
    run(args.device, args.smoke)
