"""The plain-numpy **reference** backend — the debugging half of the ABI.

Every cataloged routine of the bundled libraries, implemented with
nothing but numpy: no jit, no device arrays, no kernels. Two uses:

* **conformance oracle** — the backend suite runs every routine on both
  backends from the same inputs and asserts numerically-close results
  and identical output specs (``tests/test_torch_backend.py``); a
  torch-side regression shows up as divergence from this backend;
* **debugging tool** — ``AlchemistContext(backend="reference")`` runs a
  whole session against it, so a wrong answer can be bisected to either
  the math (reference agrees) or the accelerated implementation
  (reference disagrees). The engine still owns handles, layouts, and
  sharding — only the compute swaps.

Routines that *generate* randomness (``random_matrix``,
``random_features``, ``randomized_svd``'s sketch, ``nmf``'s init) use
numpy's own generator: cross-backend runs agree in distribution and in
the invariants the conformance suite checks, not bit-for-bit — jax's
counter-based PRNG is not reproducible without jax.

Implementations receive numpy arrays for matrix params (the engine
materializes handles via :meth:`to_native`, copying device tensors to
host; bfloat16 comes out as ml_dtypes bfloat16, as ``np.asarray`` of a
JAX bf16 array does) and return
numpy arrays — the engine mints output handles through its put path, so
reference results land on the engine device in the same layout torch
results do.

The mllib baseline's implementations are *shared* with the torch backend
by design: the pure-Spark comparison is row-partitioned host math by
construction (see ``core/libraries/mllib.py``), so both backends
delegate to the same RowMatrix driver.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import spans
from repro_torch.core.backends import base
from repro_torch.core.backends.base import REPLICATED, ROWBLOCK
from repro_torch.core.libraries import mllib
from repro_torch.frontend.rowmatrix import RowMatrix
from repro_torch.interop import tensor_to_numpy

# layouts the dense kernels consume directly; a block2d operand is
# redistributed first (the Elemental re-layout step, made explicit)
_DENSE = (ROWBLOCK, REPLICATED)


def host_array(array) -> np.ndarray:
    """An engine tensor (any device) or array-like as a host ndarray of
    its own dtype (bfloat16 stays bfloat16, as in the JAX package)."""
    if isinstance(array, torch.Tensor):
        return tensor_to_numpy(array)
    return np.asarray(array)


class ReferenceBackend(base.ExecutionBackend):
    """Sequential numpy execution; never fuses (there is nothing to fuse
    into — each step is already a synchronous host call)."""

    name = "reference"
    supports_fusion = False

    def to_native(self, array) -> np.ndarray:
        return host_array(array)

    def is_array(self, value) -> bool:
        return isinstance(value, np.ndarray) and value.ndim >= 1


register = ReferenceBackend.register


# ---------------------------------------------------------------------------
# elemental
# ---------------------------------------------------------------------------
@register("elemental", "random_matrix", fusible=True, accepts=_DENSE)
def _random_matrix(rows: int, cols: int, seed: int = 0, scale: float = 1.0,
                   name: str = "random"):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((rows, cols))).astype(np.float32)
    return {"A": a}


@register("elemental", "replicate_cols", fusible=True, accepts=_DENSE)
def _replicate_cols(A, times: int):
    return {"A": np.tile(A, (1, times))}


@register("elemental", "multiply", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_multiply)
def _multiply(A, B):
    return {"C": A @ B}


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
    return {"C": np.ascontiguousarray(A.T)}


@register("elemental", "gram", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_gram)
def _gram(A, use_pallas: bool = False):
    # use_pallas is a jax-backend knob; the reference result is the same
    return {"G": A.T @ A}


@register("elemental", "qr", fusible=True, accepts=_DENSE)
def _qr(A):
    q, r = np.linalg.qr(A, mode="reduced")
    return {"Q": q, "R": r}


def _lanczos_gram(matvec, d: int, k: int, m: int, q0: np.ndarray):
    """Lanczos with full reorthogonalization on the Gram operator —
    the shared ARPACK-style driver (paper footnote 3), here in numpy."""
    Q = np.zeros((d, m), dtype=np.float64)
    alpha = np.zeros(m)
    beta = np.zeros(m)
    q = q0 / np.linalg.norm(q0)
    q_prev = np.zeros(d)
    b_prev = 0.0
    matvecs = 0
    for j in range(m):
        with spans.span("lanczos.step"):
            # iteration boundary: a lighter tenant far behind on fair
            # share may briefly take the host here (core/qos cooperative
            # preemption; no-op unless the engine installed a hook)
            base.yield_check()
            Q[:, j] = q
            with spans.span("lanczos.matvec"):
                w = matvec(q)
            matvecs += 1
            with spans.span("lanczos.reorth"):
                a = float(q @ w)
                alpha[j] = a
                w = w - a * q - b_prev * q_prev
                for _ in range(2):
                    w = w - Q[:, : j + 1] @ (Q[:, : j + 1].T @ w)
                b = float(np.linalg.norm(w))
                beta[j] = b
            if b < 1e-12:
                m = j + 1
                Q, alpha, beta = Q[:, :m], alpha[:m], beta[:m]
                break
            q_prev, b_prev, q = q, b, w / b
    with spans.span("lanczos.ritz"):
        T = np.diag(alpha) + np.diag(beta[: m - 1], 1) + \
            np.diag(beta[: m - 1], -1)
        evals, evecs = np.linalg.eigh(T)
        order = np.argsort(evals)[::-1][:k]
        sigma = np.sqrt(np.maximum(evals[order], 0.0))
        V = Q @ evecs[:, order]
    return sigma, V, int(m), matvecs


@register("elemental", "truncated_svd", accepts=_DENSE)
def _truncated_svd(A, k: int, oversample: int = 32, max_iters: int = 0,
                   seed: int = 0):
    x = np.asarray(A, np.float64)
    n, d = x.shape
    m = min(d, k + oversample) if max_iters == 0 else min(d, max_iters)
    rng = np.random.default_rng(seed)
    sigma, V, iters, matvecs = _lanczos_gram(
        lambda q: x.T @ (x @ q), d, k, m, rng.standard_normal(d))
    v = V.astype(A.dtype)
    u = (np.asarray(A) @ v) / np.maximum(sigma.astype(A.dtype), 1e-30)
    return {"U": u, "S": sigma.astype(np.float32), "V": v,
            "lanczos_iters": iters, "matvecs": matvecs}


@register("elemental", "gram_svd", fusible=True, accepts=_DENSE)
def _gram_svd(A, k: int, use_pallas: bool = False):
    g = np.asarray(A.T @ A, np.float64)
    evals, evecs = np.linalg.eigh(g)
    order = np.argsort(evals)[::-1][:k]
    sigma = np.sqrt(np.maximum(evals[order], 0.0))
    v = evecs[:, order]
    u = (A @ v.astype(A.dtype)) / np.maximum(sigma.astype(A.dtype), 1e-30)
    return {"U": u, "S": sigma.astype(np.float32),
            "V": v.astype(np.float32)}


@register("elemental", "randomized_svd", accepts=_DENSE)
def _randomized_svd(A, k: int, oversample: int = 8, power_iters: int = 2,
                    seed: int = 0):
    n, d = A.shape
    ell = min(d, k + oversample)
    rng = np.random.default_rng(seed)
    omega = rng.standard_normal((d, ell)).astype(A.dtype)
    y = A @ omega
    for _ in range(power_iters):
        y = A @ (A.T @ y)
    q, _ = np.linalg.qr(y, mode="reduced")
    b = q.T @ A
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    return {"U": q @ ub[:, :k], "S": s[:k], "V": np.ascontiguousarray(vt[:k].T)}


# ---------------------------------------------------------------------------
# skylark
# ---------------------------------------------------------------------------
def _np_rf_map(x: np.ndarray, rf_dim: int, bandwidth: float,
               seed: int) -> np.ndarray:
    """Rahimi-Recht RBF features, numpy generator (distribution-equal to
    the jax kernel's, not bit-equal — see module docstring)."""
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    w = (rng.standard_normal((d, rf_dim)) / bandwidth).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, rf_dim).astype(np.float32)
    z = x.astype(np.float32) @ w + b
    return (np.sqrt(2.0 / rf_dim) * np.cos(z)).astype(np.float32)


@register("skylark", "random_features", accepts=_DENSE)
def _random_features(X, rf_dim: int, bandwidth: float = 1.0, seed: int = 0):
    return {"Z": _np_rf_map(X, rf_dim, bandwidth, seed)}


@register("skylark", "cg_solve", accepts=_DENSE)
def _cg_solve(X, Y, lam: float = 1e-5, rf_dim: int = 0,
              bandwidth: float = 1.0, max_iters: int = 200,
              tol: float = 1e-8, seed: int = 0, use_pallas: bool = False):
    x = np.asarray(X)
    if rf_dim:
        x = _np_rf_map(x, rf_dim, bandwidth, seed)
    y = np.asarray(Y)
    n, d = x.shape
    lam_n = np.asarray(n * lam, x.dtype)

    b = x.T @ y
    b_norm = np.linalg.norm(b, axis=0)
    w = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = np.sum(r * r, axis=0)

    iters = 0
    rel = float(np.max(np.sqrt(rs) / np.maximum(b_norm, 1e-30)))
    history = [rel]
    while iters < max_iters and rel > tol:
        base.yield_check()          # QoS iteration boundary
        ap = x.T @ (x @ p) + lam_n * p
        alpha = rs / np.sum(p * ap, axis=0)
        w = w + alpha * p
        r = r - alpha * ap
        rs_new = np.sum(r * r, axis=0)
        p = r + (rs_new / rs) * p
        rs = rs_new
        iters += 1
        rel = float(np.max(np.sqrt(rs) / np.maximum(b_norm, 1e-30)))
        history.append(rel)

    return {
        "W": w,
        "iterations": iters,
        "relative_residual": rel,
        "residual_history": [float(h) for h in history],
        "expanded_dim": int(d),
    }


@register("skylark", "nmf", accepts=_DENSE)
def _nmf(A, k: int, max_iters: int = 100, seed: int = 0, eps: float = 1e-9):
    x = np.maximum(np.asarray(A), 0.0)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    scale = np.sqrt(np.mean(x) / k)
    w = (scale * rng.uniform(0.1, 1.0, (n, k))).astype(x.dtype)
    h = (scale * rng.uniform(0.1, 1.0, (k, d))).astype(x.dtype)
    for _ in range(max_iters):
        base.yield_check()          # QoS iteration boundary
        h = h * (w.T @ x) / (w.T @ (w @ h) + eps)
        w = w * (x @ h.T) / (w @ (h @ h.T) + eps)
    resid = float(np.linalg.norm(x - w @ h) / np.linalg.norm(x))
    return {"W": w, "H": h, "relative_residual": resid,
            "iterations": max_iters}


# ---------------------------------------------------------------------------
# mllib — shared row-partitioned baseline (backend-invariant by design)
# ---------------------------------------------------------------------------
def mllib_cg_solve(X, Y, lam: float = 1e-5, max_iters: int = 200,
                   tol: float = 1e-8, nodes: int = 20,
                   num_partitions: int = 8):
    """The pure-Spark CG baseline driven through the ABI: rebuild the
    row-partitioned RowMatrix and run the identical BSP-round math. The
    torch backend registers this same function — the baseline measures a
    *client-side* execution model, so accelerating it would unmake the
    comparison it exists for."""
    x = RowMatrix.from_array(host_array(X), num_partitions)
    y = RowMatrix.from_array(host_array(Y), num_partitions)
    w, stats = mllib.spark_cg_solve(x, y, lam=lam, max_iters=max_iters,
                                    tol=tol, nodes=nodes)
    return {"W": np.asarray(w, np.float32), **stats}


def mllib_truncated_svd(A, k: int, oversample: int = 32, nodes: int = 12,
                        seed: int = 0, num_partitions: int = 8):
    """The MLlib-style Lanczos SVD baseline through the ABI (see
    :func:`mllib_cg_solve` for why both backends share it)."""
    x = RowMatrix.from_array(host_array(A), num_partitions)
    sigma, v, stats = mllib.spark_truncated_svd(
        x, k=k, oversample=oversample, nodes=nodes, seed=seed)
    return {"S": np.asarray(sigma, np.float32),
            "V": np.asarray(v, np.float32), **stats}


register("mllib", "cg_solve", accepts=_DENSE)(mllib_cg_solve)
register("mllib", "truncated_svd", accepts=_DENSE)(mllib_truncated_svd)
