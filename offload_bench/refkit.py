"""Plain helpers that the configurations' references and controls share.

Nothing here imports the program under test (``repro_torch``), the JAX
package or JAX: these are the benchmark's own copies, frozen so that a
change to the program cannot move the yardstick.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def block_seed(seed: int, stream: str, block: int) -> int:
    """A 63-bit generator seed for one row block of one input stream."""
    digest = hashlib.sha256(f"{seed}:{stream}:{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, stream: str, block: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(block_seed(seed, stream, block))
    return g


def row_blocks(n: int, block_rows: int) -> list[tuple[int, int]]:
    return [(lo, min(n, lo + block_rows)) for lo in range(0, n, block_rows)]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) with its mantissa rounded to TF32's 10 bits, to
    nearest: the operand a TF32 tensor-core product reads."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_round_(t: torch.Tensor, block_rows: int = 65_536) -> None:
    """Round a 2-D float32 tensor to TF32 in place, by row blocks."""
    for lo, hi in row_blocks(t.shape[0], block_rows):
        t[lo:hi] = tf32_round(t[lo:hi])


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a TF32 tensor-core product: both operands rounded to TF32,
    products summed in float32 (TF32 itself off, so nothing rounds twice)."""
    return tf32_round(a.float()) @ tf32_round(b.float())


def rf_weights(d: int, rf_dim: int, bandwidth: float, seed: int):
    """Rahimi-Recht RBF random-feature weights, W ~ N(0, 1/bw^2) and
    b ~ U[0, 2 pi), drawn with numpy's ``default_rng(seed)`` in the order
    the system draws them (a job's ``seed`` argument). float32 arrays."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, rf_dim)) / bandwidth).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, rf_dim).astype(np.float32)
    return w, b


def rf_features(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
    """Z = sqrt(2/D) cos(X W + b) in x's dtype (float64 for the
    reference; float32 with TF32 products for the control)."""
    z = tf32_mm(x, w) if tf32 else x @ w
    z += b
    return z.cos_().mul_(math.sqrt(2.0 / w.shape[1]))


def lanczos(matvec, d: int, k: int, m: int, q0: np.ndarray):
    """Top-k eigenpairs of a symmetric operator by m steps of Lanczos with
    full reorthogonalisation (twice), float64 on the host. Returns
    (eigenvalues descending, vectors (d, k))."""
    basis = np.zeros((d, m))
    alpha, beta = np.zeros(m), np.zeros(m)
    q = q0 / np.linalg.norm(q0)
    q_prev, b_prev = np.zeros(d), 0.0
    for j in range(m):
        basis[:, j] = q
        w = matvec(q)
        alpha[j] = q @ w
        w = w - alpha[j] * q - b_prev * q_prev
        for _ in range(2):
            w -= basis[:, :j + 1] @ (basis[:, :j + 1].T @ w)
        beta[j] = np.linalg.norm(w)
        if beta[j] < 1e-12:
            m = j + 1
            basis, alpha, beta = basis[:, :m], alpha[:m], beta[:m]
            break
        q_prev, b_prev, q = q, beta[j], w / beta[j]
    t = np.diag(alpha) + np.diag(beta[:m - 1], 1) + np.diag(beta[:m - 1], -1)
    evals, evecs = np.linalg.eigh(t)
    order = np.argsort(evals)[::-1][:k]
    return evals[order], basis @ evecs[:, order]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want||_F / ||want||_F in float64; inf when shapes differ or
    anything is not finite."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        return math.inf
    num = torch.linalg.norm(got - want)
    out = float(num / torch.linalg.norm(want))
    return out if math.isfinite(out) else math.inf


def finite_or_inf(x: float) -> float:
    x = float(x)
    return x if math.isfinite(x) else math.inf
