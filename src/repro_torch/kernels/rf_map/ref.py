"""Plain PyTorch version of the random-feature map, and its weights."""
import math

import numpy as np
import torch


def rf_weights(d: int, rf_dim: int, bandwidth: float, seed: int):
    """Rahimi-Recht RBF random features, W ~ N(0, 1/bw^2) and
    b ~ U[0, 2pi), drawn with numpy's ``default_rng(seed)`` in the order
    the JAX package's reference backend draws them, so both expand the
    same data to the same features. Returns float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, rf_dim)) / bandwidth).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, rf_dim).astype(np.float32)
    return w, b


def rf_map_ref(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Z = sqrt(2/D) cos(X W + b), fp32. The elementwise steps run in
    place on the product, so the peak is one (n, D) tensor: at
    1,048,576 x 10,000 that is 41.9 GB."""
    d_out = w.shape[1]
    z = x.float() @ w.float()
    z += b.float()
    return z.cos_().mul_(math.sqrt(2.0 / d_out))
