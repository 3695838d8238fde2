"""Paper §4.2 end-to-end on the PyTorch port (``repro_torch``): rank-20 truncated SVD of an ocean-temperature-like
field, three use cases (Table 5) plus the Fig. 3 weak-scaling column
replication — at CPU scale, with the modeled cluster-scale numbers printed
alongside the paper's.

    PYTHONPATH=src python examples/torch_ocean_svd.py [--device cpu]

The engine runs on one CUDA card by default; ``--device cpu`` runs it on
the CPU.
"""
import argparse
import time

import numpy as np

from repro_torch.core import AlchemistContext
from repro_torch.core.costmodel import socket_transfer_seconds
from repro_torch.core.libraries import elemental, mllib
from repro_torch.frontend.rowmatrix import RowMatrix


def ocean_like(n=16_384, d=512, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 67 * 30, n)[:, None]
    modes = np.stack([np.sin(2 * np.pi * t[:, 0] / p)
                      for p in (365.0, 182.5, 91.2, 30.4, 3650.0)], axis=1)
    return (modes @ rng.randn(5, d) + 0.05 * rng.randn(n, d)) \
        .astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    x = ocean_like()
    k = 20
    print(f"ocean-like field: {x.shape} ({x.nbytes / 1e6:.0f} MB; the "
          "paper's is 6,177,583 x 8,096 = 400GB)")

    # use case 1: client-only
    xm = RowMatrix.from_array(x, 12)
    t0 = time.perf_counter()
    sig1, v1, st = mllib.spark_truncated_svd(xm, k)
    t1 = time.perf_counter() - t0
    print(f"[case 1] spark-only SVD: {t1:.2f}s "
          f"({st['bsp_rounds']} BSP rounds)   paper: 553.1s")

    # use case 2: client loads, engine computes — the typed façade API:
    # routine outputs are lazy AlMatrix proxies, validated client-side
    ac = AlchemistContext(num_workers=4, device=args.device)
    ac.register_library("elemental", elemental)
    el = ac.library("elemental")
    t0 = time.perf_counter()
    al = ac.send_matrix(xm)
    U, S, V = el.truncated_svd(A=al, k=k)
    u = U.to_row_matrix()
    t2 = time.perf_counter() - t0
    print(f"[case 2] spark-load + alchemist-SVD: {t2:.2f}s measured "
          f"  paper: 121.9s (4.5x)")
    print("         (measured here, not on the paper's cluster; the "
          "cluster-scale gap comes from the modeled BSP overhead, see "
          "benchmarks table5)")

    # use case 3: engine loads and computes — the two stages chain
    # lazily (one submit each, the SVD riding a dependency edge)
    t0 = time.perf_counter()
    gen = el.random_matrix(rows=x.shape[0], cols=x.shape[1], seed=3)
    U3, _, _ = el.truncated_svd(A=gen, k=k)
    _ = U3.to_row_matrix()
    t3 = time.perf_counter() - t0
    print(f"[case 3] alchemist-load + SVD: {t3:.2f}s measured "
          f"  paper: 69.7s (7.9x)")

    # agreement
    sig2 = S.to_numpy().ravel()
    print(f"sigma agreement (case1 vs case2): "
          f"{np.abs(sig1 - sig2).max() / sig1[0]:.2e}")

    # Fig 3: weak scaling by column replication
    print("\nFig 3 weak scaling (column replication):")
    for times in (1, 2, 4):
        h = gen if times == 1 else el.replicate_cols(A=gen, times=times)
        t0 = time.perf_counter()
        el.truncated_svd(A=h, k=k, oversample=12)[0].result()
        t = time.perf_counter() - t0
        print(f"  x{times}: {t:.2f}s -> weak-scaled wall "
              f"(t/x) = {t / times:.2f}s")

    # modeled 400GB transfer (the paper's dominant case-2 overhead)
    m = socket_transfer_seconds(6_177_583 * 8_096 * 8, 320, 384)
    print(f"\nmodeled 400GB socket transfer at paper's allocation: {m:.0f}s "
          "(paper measured 62.5s)")
    ac.stop()


if __name__ == "__main__":
    main()
