"""The port's client, handles, protocol and libraries
(``repro_torch.core``) under the tests of ``tests/test_alchemist.py``,
test for test, on the CPU.

Alchemist system tests: context/handles/protocol/libraries — the paper's
§3 behaviours plus numerical correctness of every offloaded routine."""
import numpy as np
import pytest

from repro_torch.core import AlchemistContext
from repro_torch.core import protocol
from repro_torch.core.context import AlchemistError
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import elemental, mllib, skylark
from repro_torch.frontend.rowmatrix import RowMatrix

RNG = np.random.RandomState(0)


@pytest.fixture()
def ac():
    ctx = AlchemistContext(device="cpu")
    ctx.register_library("elemental", elemental)
    ctx.register_library("skylark", skylark)
    yield ctx
    ctx.stop()
    ctx.engine.shutdown()


def test_protocol_roundtrip_with_handles():
    h = MatrixHandle.fresh((3, 4), "float32", name="A")
    cmd = protocol.Command("lib", "routine", {"A": h, "k": 5, "tol": 1e-3},
                           session=7)
    back = protocol.decode_command(protocol.encode_command(cmd))
    assert back.routine == "routine" and back.session == 7
    assert back.args["A"] == h and back.args["k"] == 5


def test_protocol_rejects_arrays():
    with pytest.raises(TypeError):
        protocol.encode_command(protocol.Command(
            "lib", "r", {"A": np.zeros(3)}))


def test_unknown_library_and_routine_error(ac):
    with pytest.raises(AlchemistError, match="not registered"):
        ac.call("nope", "qr")
    with pytest.raises(AlchemistError, match="not in"):
        ac.call("elemental", "nope")


def test_stopped_context_refuses_calls(ac):
    ac.stop()
    with pytest.raises(AlchemistError):
        ac.call("elemental", "qr")


def test_engine_side_error_propagates(ac):
    ghost = MatrixHandle.fresh((3, 3), "float32")
    with pytest.raises(AlchemistError, match="KeyError"):
        ac.call("elemental", "qr", A=ghost)


def test_qr_decomposition(ac):
    a = RNG.randn(200, 50)
    res = ac.call("elemental", "qr", A=ac.send_matrix(a))
    q = ac.wrap(res["Q"]).to_numpy()
    r = ac.wrap(res["R"]).to_numpy()
    np.testing.assert_allclose(q @ r, a, atol=1e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(50), atol=1e-4)


def test_truncated_svd_matches_numpy(ac):
    x = RNG.randn(400, 60) @ np.diag(np.geomspace(10, 0.01, 60))
    res = ac.call("elemental", "truncated_svd", A=ac.send_matrix(x), k=8)
    s = ac.wrap(res["S"]).to_numpy().ravel()
    want = np.linalg.svd(x, compute_uv=False)[:8]
    np.testing.assert_allclose(s, want, rtol=1e-4)
    u = ac.wrap(res["U"]).to_numpy()
    v = ac.wrap(res["V"]).to_numpy()
    np.testing.assert_allclose(u @ np.diag(s) @ v.T,
                               (np.linalg.svd(x)[0][:, :8] * want)
                               @ np.linalg.svd(x)[2][:8],
                               atol=1e-3 * want[0])


def test_gram_svd_matches_numpy_and_uses_kernel(ac):
    """The gram kernel's path through the library layer (its plain
    version on the CPU)."""
    x = RNG.randn(512, 96) @ np.diag(np.geomspace(8, 0.05, 96))
    res = ac.call("elemental", "gram_svd", A=ac.send_matrix(x), k=6,
                  use_pallas=True)
    s = ac.wrap(res["S"]).to_numpy().ravel()
    want = np.linalg.svd(x, compute_uv=False)[:6]
    np.testing.assert_allclose(s, want, rtol=1e-3)


def test_randomized_svd_close_to_numpy(ac):
    x = RNG.randn(300, 50) @ np.diag(np.geomspace(5, 0.001, 50))
    res = ac.call("elemental", "randomized_svd", A=ac.send_matrix(x), k=5,
                  power_iters=3)
    s = ac.wrap(res["S"]).to_numpy().ravel()
    want = np.linalg.svd(x, compute_uv=False)[:5]
    np.testing.assert_allclose(s, want, rtol=1e-3)


def test_cg_solves_normal_equations(ac):
    x = RNG.randn(300, 20)
    y = RNG.randn(300, 3)
    lam = 1e-3
    res = ac.call("skylark", "cg_solve", X=ac.send_matrix(x),
                  Y=ac.send_matrix(y), lam=lam, max_iters=500, tol=1e-10)
    w = ac.wrap(res["W"]).to_numpy()
    want = np.linalg.solve(x.T @ x + 300 * lam * np.eye(20), x.T @ y)
    np.testing.assert_allclose(w, want, atol=1e-5)
    assert res["iterations"] <= 25
    # residual history is monotone-ish and ends tiny
    assert res["residual_history"][-1] < 1e-9


def test_cg_with_engine_side_rf_expansion(ac):
    """The paper's §4.1 flow: only the raw (n x d) matrix crosses the
    bridge; the expansion to rf_dim happens engine-side."""
    x = RNG.randn(200, 10)
    y = RNG.randn(200, 2)
    bytes_before = ac.engine.transfer_log.total_bytes
    res = ac.call("skylark", "cg_solve", X=ac.send_matrix(x),
                  Y=ac.send_matrix(y), lam=1e-3, rf_dim=128, max_iters=400,
                  tol=1e-9)
    sent = ac.engine.transfer_log.total_bytes - bytes_before
    assert res["expanded_dim"] == 128
    assert sent < 1.1 * (x.nbytes + y.nbytes)     # expansion did NOT cross
    assert res["relative_residual"] < 1e-6


def test_handle_chaining_stays_engine_side(ac):
    """random_matrix -> gram -> qr without any client materialization."""
    res = ac.call("elemental", "random_matrix", rows=128, cols=32, seed=1)
    n_transfers = len(ac.engine.transfer_log.records)
    res2 = ac.call("elemental", "gram", A=res["A"])
    res3 = ac.call("elemental", "qr", A=res2["G"])
    assert len(ac.engine.transfer_log.records) == n_transfers  # no crossing
    assert res3["Q"].shape == (32, 32)


def test_replicate_cols_weak_scaling_shape(ac):
    res = ac.call("elemental", "random_matrix", rows=64, cols=16)
    res2 = ac.call("elemental", "replicate_cols", A=res["A"], times=4)
    assert res2["A"].shape == (64, 64)


def test_free_releases_engine_memory(ac):
    al = ac.send_matrix(RNG.randn(100, 100))
    before = ac.engine.resident_bytes()
    al.free()
    assert ac.engine.resident_bytes() < before


def test_spark_baseline_agrees_with_alchemist(ac):
    """Both sides of the paper's comparison must compute the same answer."""
    x = RNG.randn(250, 15)
    y = RNG.randn(250, 2)
    res = ac.call("skylark", "cg_solve", X=ac.send_matrix(x),
                  Y=ac.send_matrix(y), lam=1e-3, max_iters=500, tol=1e-12)
    w_alch = ac.wrap(res["W"]).to_numpy()
    w_spark, stats = mllib.spark_cg_solve(
        RowMatrix.from_array(x, 4), RowMatrix.from_array(y, 4),
        lam=1e-3, max_iters=500, tol=1e-12)
    np.testing.assert_allclose(w_alch, w_spark, atol=1e-5)
    assert stats["bsp_rounds"] >= stats["iterations"]


def test_concurrent_sessions_share_engine():
    engine_ctx = AlchemistContext(device="cpu")
    engine_ctx.register_library("elemental", elemental)
    ac2 = AlchemistContext(engine=engine_ctx.engine)
    assert ac2.session != engine_ctx.session
    res = ac2.call("elemental", "random_matrix", rows=8, cols=8)
    assert res["A"].shape == (8, 8)


def test_mllib_stats_dict_contract():
    """Both pure-Spark entry points report the same accounting contract:
    measured wall time, BSP round count, and the Table-2-calibrated
    modeled per-round cost under one shared key name."""
    x = RowMatrix.from_array(RNG.randn(120, 10), 4)
    y = RowMatrix.from_array(RNG.randn(120, 2), 4)

    _, cg_stats = mllib.spark_cg_solve(x, y, lam=1e-3, max_iters=50)
    assert set(cg_stats) == {"iterations", "bsp_rounds",
                             "relative_residual", "measured_seconds",
                             "modeled_iteration_seconds"}

    _, _, svd_stats = mllib.spark_truncated_svd(x, k=3)
    assert set(svd_stats) == {"bsp_rounds", "measured_seconds",
                              "modeled_iteration_seconds", "lanczos_iters"}
    assert "modeled_round_overhead_seconds" not in svd_stats

    for stats in (cg_stats, svd_stats):
        assert stats["bsp_rounds"] >= 1
        assert stats["measured_seconds"] > 0
        assert stats["modeled_iteration_seconds"] > 0
    # the modeled per-round cost is the same quantity in both entry
    # points: identical (nodes, shape) must price identically
    _, cg12 = mllib.spark_cg_solve(x, y, lam=1e-3, max_iters=5, nodes=12)
    _, _, svd12 = mllib.spark_truncated_svd(x, k=3, nodes=12)
    assert cg12["modeled_iteration_seconds"] == \
        svd12["modeled_iteration_seconds"]
