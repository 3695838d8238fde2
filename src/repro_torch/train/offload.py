"""Trainer-side offload utilities: the Alchemist engine serving the
training loop (beyond-paper integration of the paper's §4.1 routine).

``fit_linear_head_cg`` ridge-fits a readout head on model features via the
*offloaded* CG solver — the classic "frozen backbone + linear probe" task,
which is exactly the paper's regularized least-squares workload with the
feature extractor swapped from random features to a trained model. On a
card the solve's X^T (X w) runs the normal_matvec kernel.

The JAX package's ``train/offload.py``; the port's model holds its
parameters, so :func:`extract_features` takes none.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


@torch.inference_mode()
def extract_features(model, batches: Iterable[dict],
                     max_batches: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Run batches ({"tokens", "labels"} tensors on the model's device)
    through the model trunk; mean-pool final hidden states. Returns
    (features (N, d), labels (N,)) with next-token labels pooled to a
    per-sequence target id (toy probe task)."""
    feats, labels = [], []
    for i, batch in enumerate(batches):
        if i >= max_batches:
            break
        h, _ = model(batch["tokens"])                   # (B, S, d)
        feats.append(h.float().mean(dim=1).cpu().numpy())
        labels.append(batch["labels"][:, -1].cpu().numpy())
    return np.concatenate(feats), np.concatenate(labels)


def fit_linear_head_cg(ac, features: np.ndarray, labels: np.ndarray,
                       num_classes: int, lam: float = 1e-3,
                       max_iters: int = 300, tol: float = 1e-8):
    """Offload the ridge solve (X^T X + n lam I) W = X^T Y to the engine.

    Returns (W (d, C), stats dict from the engine)."""
    y = np.eye(num_classes, dtype=np.float32)[labels]
    al_x = ac.send_matrix(features.astype(np.float32))
    al_y = ac.send_matrix(y)
    res = ac.call("skylark", "cg_solve", X=al_x, Y=al_y, lam=lam,
                  max_iters=max_iters, tol=tol)
    w = ac.wrap(res["W"]).to_numpy()
    al_x.free()
    al_y.free()
    return w, res


def head_accuracy(w: np.ndarray, features: np.ndarray,
                  labels: np.ndarray) -> float:
    return float(np.mean(np.argmax(features @ w, axis=1) == labels))
