"""The PyTorch backend — the port's counterpart of the JAX package's
``jax_backend.py``, and the engine's default execution environment.

Implementations are tensor-level: torch tensors in, torch tensors out, on
whatever device the engine keeps its stores (one CUDA device, or the CPU
when a caller asks for it). Three routines go through the port's
hand-written kernels (``repro_torch/kernels``):

* ``gram`` and ``gram_svd`` through ``gram``;
* ``cg_solve``'s iteration through ``normal_matvec``;
* ``cg_solve``'s ``rf_dim`` expansion and ``random_features`` through
  ``rf_map``.

**``use_pallas`` selects nothing here.** The parameter stays in every
routine signature and library catalog, so the wire catalogs are
byte-identical to the JAX package's; in the port the *device* decides: a
CUDA tensor always launches the CUDA kernel, a CPU tensor always takes
the kernel's plain PyTorch version. There is no fallback between them.

Random values (``random_matrix``, ``random_features``, the ``rf_dim``
expansion, the Lanczos start vector, ``randomized_svd``'s sketch,
``nmf``'s init) are drawn with numpy's ``default_rng(seed)`` exactly as
the reference backend draws them, so the two agree bit for bit on what
they draw (the JAX backend's threefry draws agree in distribution only).

The backend never fuses (``supports_fusion = False``, no
``get_or_compile``): the engine runs every step eagerly. Host-loop
drivers (Lanczos SVD, CG, NMF) are reverse-communication loops around
device products, as in the JAX backend.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backends import base
from repro_torch.core.backends.base import REPLICATED, ROWBLOCK
from repro_torch.core.backends.reference import (
    _lanczos_gram,
    mllib_cg_solve,
    mllib_truncated_svd,
)
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.normal_matvec import ops as nm_ops
from repro_torch.kernels.rf_map import ops as rf_ops

_DENSE = (ROWBLOCK, REPLICATED)


class TorchBackend(base.ExecutionBackend):
    """Eager PyTorch execution on the engine's device."""

    name = "torch"
    supports_fusion = False

    def to_native(self, array) -> torch.Tensor:
        return array if isinstance(array, torch.Tensor) \
            else torch.as_tensor(array)

    def is_array(self, value) -> bool:
        return isinstance(value, (torch.Tensor, np.ndarray)) and \
            value.ndim >= 1


register = TorchBackend.register


def _from_host(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array on ``like``'s device, in ``like``'s dtype."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(
        device=like.device, dtype=like.dtype)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their common dtype (jnp promotes implicitly;
    torch.matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ---------------------------------------------------------------------------
# elemental
# ---------------------------------------------------------------------------
@register("elemental", "random_matrix", fusible=True, accepts=_DENSE)
def _random_matrix(rows: int, cols: int, seed: int = 0, scale: float = 1.0,
                   name: str = "random"):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((rows, cols))).astype(np.float32)
    return {"A": torch.from_numpy(a)}


@register("elemental", "replicate_cols", fusible=True, accepts=_DENSE)
def _replicate_cols(A, times: int):
    return {"A": A.repeat(1, times)}


@register("elemental", "multiply", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_multiply)
def _multiply(A, B):
    a, b = _promoted(A, B)
    return {"C": a @ b}


@register("elemental", "add", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_add)
def _add(A, B):
    if A.shape != B.shape:
        raise ValueError(f"add expects equal shapes, got {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    return {"C": A + B}


@register("elemental", "transpose", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_transpose)
def _transpose(A):
    return {"C": A.T}


@register("elemental", "gram", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_gram)
def _gram(A, use_pallas: bool = False):
    return {"G": gram_ops.gram(A.contiguous())}


@register("elemental", "qr", fusible=True, accepts=_DENSE)
def _qr(A):
    q, r = torch.linalg.qr(A, mode="reduced")
    return {"Q": q, "R": r}


@register("elemental", "truncated_svd", accepts=_DENSE)
def _truncated_svd(A, k: int, oversample: int = 32, max_iters: int = 0,
                   seed: int = 0):
    """ARPACK-style driver: the shared host-side Lanczos loop
    (``reference._lanczos_gram``) around a device matvec X^T (X q), as
    the JAX backend drives its jitted ``_gram_matvec``."""
    x = A
    n, d = x.shape
    m = min(d, k + oversample) if max_iters == 0 else min(d, max_iters)
    q0 = np.random.default_rng(seed).standard_normal(d)

    def matvec(q):
        # each Lanczos iteration re-enters here: the natural QoS
        # preemption boundary for the reverse-communication driver
        base.yield_check()
        qd = _from_host(q, x)
        return (x.T @ (x @ qd)).double().cpu().numpy()

    sigma, V, iters, matvecs = _lanczos_gram(matvec, d, k, m, q0)
    v_dev = _from_host(V, x)
    U = (x @ v_dev) / torch.clamp(_from_host(sigma, x), min=1e-30)
    return {"U": U, "S": torch.from_numpy(sigma.astype(np.float32)),
            "V": v_dev, "lanczos_iters": iters, "matvecs": matvecs}


@register("elemental", "gram_svd", fusible=True, accepts=_DENSE)
def _gram_svd(A, k: int, use_pallas: bool = False):
    x = A
    g = gram_ops.gram(x.contiguous())
    evals, evecs = torch.linalg.eigh(g)
    order = torch.flip(torch.argsort(evals), dims=(0,))[:k]
    lam = torch.clamp(evals[order], min=0.0)
    sigma = torch.sqrt(lam)
    v = evecs[:, order]
    u = (x @ v.to(x.dtype)) / torch.clamp(sigma.to(x.dtype), min=1e-30)
    return {"U": u, "S": sigma.float(), "V": v.float()}


@register("elemental", "randomized_svd", accepts=_DENSE)
def _randomized_svd(A, k: int, oversample: int = 8, power_iters: int = 2,
                    seed: int = 0):
    x = A
    n, d = x.shape
    ell = min(d, k + oversample)
    rng = np.random.default_rng(seed)
    omega = _from_host(rng.standard_normal((d, ell)), x)
    y = x @ omega
    for _ in range(power_iters):
        y = x @ (x.T @ y)
    q, _ = torch.linalg.qr(y, mode="reduced")
    b = q.T @ x                                                # (ell, d)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    return {"U": q @ ub[:, :k], "S": s[:k], "V": vt[:k].T}


# ---------------------------------------------------------------------------
# skylark
# ---------------------------------------------------------------------------
@register("skylark", "random_features", accepts=_DENSE)
def _random_features(X, rf_dim: int, bandwidth: float = 1.0, seed: int = 0):
    return {"Z": rf_ops.rf_map(X.contiguous(), rf_dim, bandwidth=bandwidth,
                               seed=seed)}


def _cg_step(x, lam_n, state):
    """One CG iteration on the normal equations; X^T (X p) is one
    normal_matvec launch (mirrors the JAX backend's ``_cg_step``)."""
    w, r, p, rs = state
    ap = nm_ops.normal_matvec(x, p.float()).to(x.dtype) + lam_n * p
    alpha = rs / torch.sum(p * ap, dim=0)
    w = w + alpha * p
    r = r - alpha * ap
    rs_new = torch.sum(r * r, dim=0)
    p = r + (rs_new / rs) * p
    return w, r, p, rs_new


@register("skylark", "cg_solve", accepts=_DENSE)
def _cg_solve(X, Y, lam: float = 1e-5, rf_dim: int = 0,
              bandwidth: float = 1.0, max_iters: int = 200,
              tol: float = 1e-8, seed: int = 0, use_pallas: bool = False):
    x = X.contiguous()
    if rf_dim:
        x = rf_ops.rf_map(x, rf_dim, bandwidth=bandwidth, seed=seed)
    x, y = _promoted(x, Y)
    n, d = x.shape
    lam_n = torch.tensor(n * lam, dtype=x.dtype, device=x.device)

    b = x.T @ y                                  # (d, c) rhs
    b_norm = torch.linalg.norm(b, dim=0)
    w = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=0)

    iters = 0
    floor = torch.clamp(b_norm, min=1e-30)
    rel = float(torch.max(torch.sqrt(rs) / floor))
    history = [rel]
    state = (w, r, p, rs)
    while iters < max_iters and rel > tol:
        base.yield_check()          # QoS iteration boundary
        state = _cg_step(x, lam_n, state)
        iters += 1
        rel = float(torch.max(torch.sqrt(state[3]) / floor))
        history.append(rel)

    return {
        "W": state[0],
        "iterations": iters,
        "relative_residual": rel,
        "residual_history": [float(h) for h in history],
        "expanded_dim": int(d),
    }


@register("skylark", "nmf", accepts=_DENSE)
def _nmf(A, k: int, max_iters: int = 100, seed: int = 0, eps: float = 1e-9):
    x = torch.clamp(A, min=0.0)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    scale = float(np.sqrt(float(torch.mean(x)) / k))
    w = _from_host(scale * rng.uniform(0.1, 1.0, (n, k)), x)
    h = _from_host(scale * rng.uniform(0.1, 1.0, (k, d)), x)
    for _ in range(max_iters):
        base.yield_check()          # QoS iteration boundary
        h = h * (w.T @ x) / (w.T @ (w @ h) + eps)
        w = w * (x @ h.T) / (w @ (h @ h.T) + eps)
    resid = float(torch.linalg.norm(x - w @ h) / torch.linalg.norm(x))
    return {"W": w, "H": h, "relative_residual": resid,
            "iterations": max_iters}


# ---------------------------------------------------------------------------
# mllib — shared with the reference backend: the pure-Spark baseline is
# client-side row-partitioned math by construction; accelerating it would
# unmake the comparison
# ---------------------------------------------------------------------------
register("mllib", "cg_solve", accepts=_DENSE)(mllib_cg_solve)
register("mllib", "truncated_svd", accepts=_DENSE)(mllib_truncated_svd)
