"""The "Elemental" ALI: distributed dense linear algebra on the engine mesh.

Routines mirror what the paper offloads: Gram matrices, QR (TSQR), and the
rank-k truncated SVD computed ARPACK-style — a Lanczos eigensolver driven on
the Gram matrix, where each matvec v -> X^T (X v) is a distributed two-pass
product over the row-sharded data (the paper's footnote 3: "both
implementations use ARPACK to compute the eigenvalues of the Gram matrix").

As of the backend ABI this module is the library's **declaration**: each
routine's typed schema (:func:`spec.routine` — parameter kinds read off
the signature, ordered output names for client-side tuple unpacking) and
nothing else. The engine catalogs these at ``load_library`` time and
serves them over the ``describe`` endpoint, exactly as before; the
*implementations* live in per-backend registries —
``core/backends/jax_backend.py`` (GSPMD + Pallas kernels, chain fusion)
and ``core/backends/reference.py`` (plain numpy) — and the engine
dispatches execution plans through the session's selected backend. The
bodies here raise if called directly: the engine never invokes a library
function any more, and neither should anything else.
"""
from __future__ import annotations

from repro_torch.core.libraries.spec import routine, spec_only


@routine(outputs=("A",))
def random_matrix(engine, rows: int, cols: int, seed: int = 0,
                  scale: float = 1.0, name: str = "random"):
    """Engine-side data creation (the paper's 'Alchemist loads the data'
    use case — use case 3 of Table 5 — without the client round trip)."""
    raise spec_only("elemental", "random_matrix")


@routine(outputs=("A",))
def replicate_cols(engine, A, times: int):
    """Column-wise replication (paper Fig. 3: 2.2TB -> 17.6TB scaling)."""
    raise spec_only("elemental", "replicate_cols")


@routine(outputs=("C",))
def multiply(engine, A, B):
    """C = A B (the lowering target of client-side ``A @ B``)."""
    raise spec_only("elemental", "multiply")


@routine(outputs=("C",))
def add(engine, A, B):
    """Elementwise C = A + B (the lowering target of client-side
    ``A + B`` on AlMatrix proxies)."""
    raise spec_only("elemental", "add")


@routine(outputs=("C",))
def transpose(engine, A):
    """C = A^T (the lowering target of client-side ``A.T``)."""
    raise spec_only("elemental", "transpose")


@routine(outputs=("G",))
def gram(engine, A, use_pallas: bool = False):
    """G = A^T A via the blocked kernel (interpret-mode on CPU)."""
    raise spec_only("elemental", "gram")


@routine(outputs=("Q", "R"))
def qr(engine, A):
    """Thin QR. On the engine mesh the row-sharded x makes this a TSQR-like
    computation under GSPMD (per-shard factor + small recombine)."""
    raise spec_only("elemental", "qr")


@routine(outputs=("U", "S", "V"))
def truncated_svd(engine, A, k: int, oversample: int = 32,
                  max_iters: int = 0, seed: int = 0):
    """Rank-k truncated SVD, ARPACK-style: Lanczos (full reorthogonalization)
    on the Gram matrix G = X^T X, then U = X V diag(1/sigma).

    The Lanczos driver is a host loop of jitted distributed matvecs — the
    same structure as ARPACK's reverse-communication interface driving
    distributed matvecs in the paper's MPI implementation.
    """
    raise spec_only("elemental", "truncated_svd")


@routine(outputs=("U", "S", "V"))
def gram_svd(engine, A, k: int, use_pallas: bool = False):
    """Direct route for modest column counts (the paper's ocean matrix is
    6.1M x 8096 — exactly this regime): form G = A^T A with the blocked
    Pallas kernel, eigh the (d, d) Gram, take the top-k pairs."""
    raise spec_only("elemental", "gram_svd")


@routine(outputs=("U", "S", "V"))
def randomized_svd(engine, A, k: int, oversample: int = 8,
                   power_iters: int = 2, seed: int = 0):
    """RandNLA alternative (Halko et al.): range finder + small SVD."""
    raise spec_only("elemental", "randomized_svd")


ROUTINES = {
    "random_matrix": random_matrix,
    "replicate_cols": replicate_cols,
    "multiply": multiply,
    "add": add,
    "transpose": transpose,
    "gram": gram,
    "qr": qr,
    "truncated_svd": truncated_svd,
    "gram_svd": gram_svd,
    "randomized_svd": randomized_svd,
}
