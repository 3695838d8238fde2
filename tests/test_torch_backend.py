"""The port's torch backend against the JAX package's backends, routine for
routine: every registration of ``repro_torch``'s ``TorchBackend`` run on the
CPU against ``repro``'s plain-numpy reference backend on the same inputs,
and registration flags equal to ``repro``'s ``JaxBackend``'s."""
import numpy as np
import pytest
import torch

from repro.core.backends.jax_backend import JaxBackend
from repro.core.backends.reference import ReferenceBackend
from repro_torch.core import backends as port_backends
from repro_torch.core.backends.torch_backend import TorchBackend

RNG = np.random.RandomState(7)
X = (RNG.randn(48, 12) @ np.diag(np.geomspace(8.0, 0.1, 12))).astype(
    np.float32)
Y = RNG.randn(48, 3).astype(np.float32)
POS = np.abs(RNG.randn(24, 10)).astype(np.float32)

TORCH = TorchBackend()
REF = ReferenceBackend()


def run_both(library, routine, arrays, scalars=None):
    """One routine on both backends from the same float32 inputs; returns
    (port outputs, reference outputs) with arrays as numpy."""
    scalars = scalars or {}
    port = TORCH.routine_impl(library, routine).fn(
        **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
        **scalars)
    ref = REF.routine_impl(library, routine).fn(
        **{k: v.copy() for k, v in arrays.items()}, **scalars)
    assert set(port) == set(ref), (library, routine)

    def host(v):
        return v.numpy() if isinstance(v, torch.Tensor) else v
    return {k: host(v) for k, v in port.items()}, ref


def test_registration_flags_equal_the_jax_backends():
    jax_impls = JaxBackend()._impls
    port_impls = TORCH._impls
    assert sorted(port_impls) == sorted(jax_impls)
    assert len(port_impls) == 15          # 10 elemental, 3 skylark, 2 mllib
    for key, ji in jax_impls.items():
        pi = port_impls[key]
        assert (pi.fusible, pi.accepts, pi.relayout_to, pi.kind,
                pi.bucketable) == (ji.fusible, ji.accepts, ji.relayout_to,
                                   ji.kind, ji.bucketable), key
        assert (pi.out_shapes is None) == (ji.out_shapes is None), key
        if ji.out_shapes is not None:
            assert pi.out_shapes.__name__ == ji.out_shapes.__name__, key


def test_registry_defaults_to_torch_and_never_fuses():
    """The torch backend fuses burst chains (one task, a CUDA graph on a
    card) and has the compile surface (``get_or_compile``, ``supports_aot``)
    through which the engine runs chains and bucketed single ops. The
    reference backend never fuses."""
    assert port_backends.DEFAULT_BACKEND == "torch"
    assert set(port_backends.available_backends()) == {"torch", "reference"}
    caps = TORCH.capabilities()
    assert caps["supports_fusion"]
    assert not port_backends.ReferenceBackend().supports_fusion
    assert hasattr(TORCH, "get_or_compile") and TORCH.supports_aot


@pytest.mark.parametrize("routine,arrays,scalars,tol", [
    ("multiply", {"A": X, "B": np.ascontiguousarray(X.T)}, {}, 1e-5),
    ("add", {"A": X, "B": X}, {}, 1e-6),
    ("transpose", {"A": X}, {}, 0.0),
    ("replicate_cols", {"A": X}, {"times": 3}, 0.0),
    ("gram", {"A": X}, {}, 1e-5),
    ("random_matrix", {}, {"rows": 64, "cols": 16, "seed": 3,
                           "scale": 2.0}, 0.0),
])
def test_elemental_linear_routines_match_reference(routine, arrays,
                                                   scalars, tol):
    port, ref = run_both("elemental", routine, arrays, scalars)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=tol,
                                   atol=tol * np.abs(ref[k]).max())
        assert port[k].dtype == ref[k].dtype, (routine, k)


def test_qr_matches_reference():
    port, ref = run_both("elemental", "qr", {"A": X})

    def canon(q, r):
        s = np.sign(np.diag(r))
        s[s == 0] = 1.0
        return q * s, r * s[:, None]
    qp, rp = canon(port["Q"], port["R"])
    qr_, rr = canon(ref["Q"], ref["R"])
    np.testing.assert_allclose(qp, qr_, atol=2e-5)
    np.testing.assert_allclose(rp, rr, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("routine,scalars", [
    ("truncated_svd", {"k": 4}),
    ("gram_svd", {"k": 4}),
    ("randomized_svd", {"k": 3, "power_iters": 3}),
])
def test_svd_routines_match_reference(routine, scalars):
    port, ref = run_both("elemental", routine, {"A": X}, scalars)
    k = scalars["k"]
    np.testing.assert_allclose(port["S"].ravel(), ref["S"].ravel(),
                               rtol=1e-4)
    want = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:k]
    np.testing.assert_allclose(port["S"].ravel(), want, rtol=1e-3)
    dots = np.abs(np.sum(port["V"] * ref["V"], axis=0))
    np.testing.assert_allclose(dots, np.ones(k), atol=1e-3)
    # U = A V / sigma in both
    np.testing.assert_allclose(np.abs(port["U"]), np.abs(ref["U"]),
                               atol=1e-3)
    for key in ("lanczos_iters", "matvecs"):
        assert port.get(key) == ref.get(key)


def test_random_features_match_reference_draws():
    port, ref = run_both("skylark", "random_features", {"X": X},
                         {"rf_dim": 64, "bandwidth": 2.0, "seed": 1})
    np.testing.assert_allclose(port["Z"], ref["Z"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rf_dim", [0, 40])
def test_cg_solve_matches_reference(rf_dim):
    port, ref = run_both("skylark", "cg_solve", {"X": X, "Y": Y},
                         {"lam": 1e-3, "rf_dim": rf_dim, "bandwidth": 2.0,
                          "max_iters": 400, "tol": 1e-10})
    np.testing.assert_allclose(port["W"], ref["W"], atol=1e-4)
    assert port["expanded_dim"] == ref["expanded_dim"] == (rf_dim or 12)
    assert port["relative_residual"] <= 1e-6


def test_cg_keeps_a_column_that_converged_exactly():
    """A ridge system whose second column's residual reaches exactly zero
    in float32 after two iterations (found by the CG property of
    ``tests/test_torch_properties.py``): the solve goes on for the other
    column and the converged one keeps its solution, where 0/0 step sizes
    made it NaN."""
    rng = np.random.RandomState(98)
    x, y = rng.randn(20, 2), rng.randn(20, 2)
    lam = 1e-2
    port = TORCH.routine_impl("skylark", "cg_solve").fn(
        X=torch.from_numpy(x.astype(np.float32)),
        Y=torch.from_numpy(y.astype(np.float32)), lam=lam, max_iters=10,
        tol=1e-12)
    want = np.linalg.solve(x.T @ x + 20 * lam * np.eye(2), x.T @ y)
    assert np.isfinite(port["residual_history"]).all()
    np.testing.assert_allclose(port["W"].numpy(), want, atol=1e-4,
                               rtol=1e-4)


def test_nmf_matches_reference_draws():
    port, ref = run_both("skylark", "nmf", {"A": POS},
                         {"k": 4, "max_iters": 60})
    assert (port["W"] >= 0).all() and (port["H"] >= 0).all()
    np.testing.assert_allclose(port["W"] @ port["H"], ref["W"] @ ref["H"],
                               atol=1e-3)
    assert abs(port["relative_residual"] - ref["relative_residual"]) < 1e-4


@pytest.mark.parametrize("routine,arrays,scalars", [
    ("cg_solve", {"X": X, "Y": Y}, {"lam": 1e-3}),
    ("truncated_svd", {"A": X}, {"k": 3}),
])
def test_mllib_baseline_is_shared(routine, arrays, scalars):
    port, ref = run_both("mllib", routine, arrays, scalars)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(port[k], v, rtol=1e-6, atol=1e-7)
        elif k != "measured_seconds":         # wall clock of each run
            assert port[k] == v, k
