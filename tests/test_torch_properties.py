"""The port's protocol, transfer, CG and SVD invariants under the
property tests of ``tests/test_properties.py`` (the two cross-entropy
properties are in ``tests/test_torch_train.py``).

Property-based tests (hypothesis) on system invariants.

Skipped cleanly when hypothesis is absent (it is declared in the
``test`` extra of pyproject.toml; CI installs it)."""
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed; pip install -e '.[test]' to run these")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import AlchemistContext  # noqa: E402
from repro_torch.core.costmodel import socket_transfer_seconds  # noqa: E402
from repro_torch.core.libraries import elemental, skylark  # noqa: E402
from repro_torch.core.protocol import (  # noqa: E402
    Command,
    decode_command,
    encode_command,
)
from repro_torch.core.handles import MatrixHandle  # noqa: E402

_AC = None


def _ac():
    global _AC
    if _AC is None:
        _AC = AlchemistContext(num_workers=1, device="cpu")
        _AC.register_library("elemental", elemental)
        _AC.register_library("skylark", skylark)
    return _AC


@settings(max_examples=20, deadline=None)
@given(n=st.integers(20, 120), d=st.integers(2, 12),
       c=st.integers(1, 3), seed=st.integers(0, 100))
def test_cg_solves_any_ridge_system(n, d, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = rng.randn(n, c)
    lam = 1e-2
    ac = _ac()
    res = ac.call("skylark", "cg_solve", X=ac.send_matrix(x),
                  Y=ac.send_matrix(y), lam=lam, max_iters=5 * d, tol=1e-12)
    w = ac.wrap(res["W"]).to_numpy()
    want = np.linalg.solve(x.T @ x + n * lam * np.eye(d), x.T @ y)
    np.testing.assert_allclose(w, want, atol=1e-4, rtol=1e-4)


@settings(max_examples=20, deadline=None)
@given(rows=st.integers(8, 64), cols=st.integers(2, 16),
       seed=st.integers(0, 50))
def test_transfer_roundtrip_preserves_data(rows, cols, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(rows, cols)
    ac = _ac()
    al = ac.send_matrix(a)
    back = al.to_numpy()
    np.testing.assert_allclose(back, a, atol=1e-6)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 8), st.integers(2, 6), st.integers(2, 6),
       st.text(max_size=10), st.integers(0, 3))
def test_protocol_roundtrip_any_args(hid, r, c, name, session):
    h = MatrixHandle(id=hid, shape=(r, c), dtype="float32", name=name or None)
    cmd = Command("lib", "fn", {"A": h, "s": name, "x": 1.5, "flag": True,
                                "nest": {"k": [1, 2, h]}}, session=session)
    back = decode_command(encode_command(cmd))
    assert back == cmd


@settings(max_examples=25, deadline=None)
@given(nbytes=st.integers(1, 10**13), a=st.integers(1, 64),
       b=st.integers(1, 64))
def test_transfer_model_monotone(nbytes, a, b):
    """More bytes never transfer faster; more (balanced) procs never slower."""
    t = socket_transfer_seconds(nbytes, a, b)
    assert t >= 0
    assert socket_transfer_seconds(nbytes * 2, a, b) >= t
    assert socket_transfer_seconds(nbytes, a + 1, b + 1) <= t + 1e-9


@settings(max_examples=10, deadline=None)
@given(n=st.integers(40, 100), d=st.integers(6, 20), k=st.integers(1, 4),
       seed=st.integers(0, 20))
def test_truncated_svd_is_best_rank_k(n, d, k, seed):
    """Eckart-Young: residual of our rank-k factors ~ sigma_{k+1}."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    ac = _ac()
    res = ac.call("elemental", "truncated_svd", A=ac.send_matrix(x), k=k)
    u = ac.wrap(res["U"]).to_numpy()
    s = ac.wrap(res["S"]).to_numpy().ravel()
    v = ac.wrap(res["V"]).to_numpy()
    resid = np.linalg.norm(x - u @ np.diag(s) @ v.T, 2)
    svals = np.linalg.svd(x, compute_uv=False)
    assert resid <= svals[k] * (1 + 1e-3) + 1e-6
