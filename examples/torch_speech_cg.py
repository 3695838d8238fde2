"""Paper §4.1 end-to-end on the PyTorch port (``repro_torch``):
speech-classification ridge regression via CG,
offloaded — raw features cross the bridge, the random-feature expansion and
the CG solve run engine-side; compared against the pure-client ("Spark")
baseline on the identical problem.

CPU-scaled stand-in for TIMIT (2.25M x 440 -> n=20k x 440 here), same
pipeline shape: X (n x d), labels one-hot Y (n x c), expansion to rf_dim,
solve (Z^T Z + n*lam*I) W = Z^T Y.

    PYTHONPATH=src python examples/torch_speech_cg.py [--rows 20000] \
        [--rf 2048] [--device cpu]

The engine runs on one CUDA card by default; ``--device cpu`` runs it on
the CPU. The client scores with the plain PyTorch feature map on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import mllib, skylark
from repro_torch.frontend.rowmatrix import RowMatrix
from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights


def make_speech_like(n, d=440, classes=32, seed=0):
    """Synthetic classification data with class-dependent means (stands in
    for the TIMIT preprocessing pipeline output). The class means are a
    fixed property of the 'task' (seed-independent); `seed` only draws the
    samples, so train/test splits share the same classes."""
    means = np.random.RandomState(12345).randn(classes, d)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    x = means[labels] + 0.8 * rng.randn(n, d)
    y = np.eye(classes, dtype=np.float32)[labels]
    return x.astype(np.float32), y, labels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--rf", type=int, default=2_048)
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    x, y, labels = make_speech_like(args.rows)
    x_test, y_test, labels_test = make_speech_like(4_000, seed=1)

    ac = AlchemistContext(num_workers=4, device=args.device)
    ac.register_library("skylark", skylark)
    sky = ac.library("skylark")                  # typed façade
    bandwidth = float(np.sqrt(x.shape[1]))       # RBF median-distance scale

    # ---- offloaded path: send raw 440-dim features only ----
    t0 = time.perf_counter()
    al_x = ac.send_matrix(x)
    al_y = ac.send_matrix(y)
    t_send = time.perf_counter() - t0
    t0 = time.perf_counter()
    W = sky.cg_solve(X=al_x, Y=al_y, lam=args.lam, rf_dim=args.rf,
                     bandwidth=bandwidth, max_iters=200, tol=1e-7)
    W.result()                                   # force: solve only
    t_solve = time.perf_counter() - t0
    w = W.to_numpy()                             # stream-back, untimed
    stats = W.stats()                            # the routine's scalars
    print(f"[alchemist] send {t_send:.2f}s | solve {t_solve:.2f}s "
          f"({stats['iterations']} CG iters, residual "
          f"{stats['relative_residual']:.1e})")

    # accuracy with the same engine-side feature map
    wmat, b = (torch.from_numpy(v)
               for v in rf_weights(x.shape[1], args.rf, bandwidth, 0))

    def features(rows):
        return rf_map_ref(torch.from_numpy(rows), wmat, b).numpy()

    z_test = features(x_test)
    acc = float(np.mean(np.argmax(z_test @ w, 1) == labels_test))
    print(f"[alchemist] test accuracy {acc:.3f} "
          f"(chance {1 / y.shape[1]:.3f})")

    # ---- client-only ("Spark") baseline: expansion computed client-side,
    #      CG pays a BSP round per iteration ----
    z_train = features(x)
    zm = RowMatrix.from_array(z_train, 16)
    ym = RowMatrix.from_array(y, 16)
    t0 = time.perf_counter()
    w_spark, stats = mllib.spark_cg_solve(zm, ym, lam=args.lam,
                                          max_iters=200, tol=1e-7)
    t_spark = time.perf_counter() - t0
    print(f"[spark]     solve {t_spark:.2f}s measured "
          f"({stats['iterations']} iters, {stats['bsp_rounds']} BSP rounds)")
    print("NOTE: client and engine share this host, so measured times are "
          "not the cluster story; the paper-calibrated model at 30 nodes/10k "
          f"features gives spark {1388 / 30 + 5.9:.1f}s/iter vs alchemist "
          f"{52 / 30 + 0.2:.1f}s/iter (~26x).")
    agree = np.abs(w - w_spark).max() / np.abs(w_spark).max()
    print(f"solutions agree to {agree:.1e} (same math, different substrate)")
    ac.stop()


if __name__ == "__main__":
    main()
