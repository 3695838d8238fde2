"""The "libSkylark" ALI: randomized-linear-algebra ML routines — the paper's
§4.1 workload. Declares Rahimi-Recht random feature expansion (done
engine-side, as the paper does, so only the small raw feature matrix crosses
the bridge) and the conjugate-gradient solver for the regularized system

    (Z^T Z + n*lambda*I) W = Z^T Y.

As of the backend ABI this module carries only the typed **declarations**
(see ``elemental.py`` for the pattern): implementations are registered
per-backend in ``core/backends/jax_backend.py`` (jitted CG over the
fused ``normal_matvec`` kernel) and ``core/backends/reference.py``
(plain numpy), and the engine dispatches through the session's selected
backend — the bodies here raise if called directly.
"""
from __future__ import annotations

from repro_torch.core.libraries.spec import routine, spec_only


@routine(outputs=("Z",))
def random_features(engine, X, rf_dim: int, bandwidth: float = 1.0,
                    seed: int = 0):
    """Z = sqrt(2/D) cos(X W / sigma + b) — expansion happens on the engine
    (paper: 'the feature matrix is instead expanded within Alchemist')."""
    raise spec_only("skylark", "random_features")


@routine(outputs=("W",))
def cg_solve(engine, X, Y, lam: float = 1e-5, rf_dim: int = 0,
             bandwidth: float = 1.0, max_iters: int = 200,
             tol: float = 1e-8, seed: int = 0, use_pallas: bool = False):
    """Solve (Z^T Z + n lam I) W = Z^T Y by CG (Z = X or its RF expansion).

    Returns the weight handle plus per-call statistics (iterations, final
    relative residual) for the benchmark tables.
    """
    raise spec_only("skylark", "cg_solve")


@routine(outputs=("W", "H"))
def nmf(engine, A, k: int, max_iters: int = 100, seed: int = 0,
        eps: float = 1e-9):
    """Non-negative matrix factorization (multiplicative updates) — the
    other factorization from the motivating case studies (Gittens et al.
    2016). A >= 0 (n, d) ~ W (n, k) H (k, d), engine-resident throughout."""
    raise spec_only("skylark", "nmf")


ROUTINES = {
    "random_features": random_features,
    "cg_solve": cg_solve,
    "nmf": nmf,
}
