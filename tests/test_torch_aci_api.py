"""The port's typed library catalog and lazy expression API
(``repro_torch.core.expr``, ``libraries``) under the tests of
``tests/test_aci_api.py``, test for test, over both bridges, with chain
fusion on.

ACI surface tests: typed catalog + describe round-trip, library
façades, fail-fast client-side validation, the unified lazy AlMatrix
(zero-round-trip chaining, operator sugar, failure propagation), the
double-free guard, and the context-manager lifecycle."""
import numpy as np
import pytest

from repro_torch.core import AlchemistContext, AlchemistEngine, AlMatrix
from repro_torch.core import protocol
from repro_torch.core.context import AlchemistError
from repro_torch.core.engine import ENGINE_LIBRARY
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import elemental, mllib, skylark
from repro_torch.core.libraries import spec as specs
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(0)


@pytest.fixture()
def engine():
    # cache off: several tests count submits / force recomputation
    eng = AlchemistEngine(device="cpu", cache_entries=0)
    yield eng
    eng.shutdown()


@pytest.fixture()
def ac(engine):
    ctx = AlchemistContext(engine=engine)
    ctx.register_library("elemental", elemental)
    ctx.register_library("skylark", skylark)
    ctx.register_library("mllib", mllib)
    return ctx


def crossings(engine) -> int:
    """Client->engine protocol crossings so far (wire endpoints only;
    transfers are counted separately via the transfer log)."""
    return sum(engine.endpoint_counts.values())


# ---- spec layer -----------------------------------------------------------
def test_routine_decorator_declares_schema():
    sp = elemental.qr.spec
    assert sp.outputs == ("Q", "R")
    assert [p.name for p in sp.params] == ["A"]
    assert sp.params[0].kind == specs.MATRIX
    assert sp.declared
    sv = elemental.truncated_svd.spec
    assert sv.outputs == ("U", "S", "V")
    k = sv.param("k")
    assert k.kind == "int" and k.required
    over = sv.param("oversample")
    assert not over.required and over.default == 32


def test_spec_bind_rejects_bad_calls():
    sp = elemental.qr.spec
    with pytest.raises(specs.SpecError, match="missing required"):
        sp.bind((), {})
    with pytest.raises(specs.SpecError, match="unexpected keyword"):
        sp.bind((), {"A": 1, "k": 2})
    with pytest.raises(specs.SpecError, match="multiple values"):
        sp.bind((1,), {"A": 2})
    with pytest.raises(specs.SpecError, match="at most"):
        sp.bind((1, 2), {})


def test_spec_wire_roundtrip_preserves_everything():
    for fn in (elemental.qr, elemental.truncated_svd, skylark.cg_solve):
        sp = fn.spec
        assert specs.from_wire(specs.to_wire(sp)) == sp


def test_undecorated_routine_catalogs_by_introspection():
    def mystery(engine, A, k: int = 3):
        return {}

    sp = specs.spec_of(mystery)
    assert not sp.declared and sp.outputs == ()
    assert sp.param("A").kind == specs.MATRIX
    assert sp.param("k").default == 3


# ---- describe endpoint ----------------------------------------------------
def test_describe_roundtrips_all_bundled_libraries(ac):
    cats = ac._describe()
    for lib, module in (("elemental", elemental), ("skylark", skylark),
                        ("mllib", mllib)):
        assert lib in cats
        wire = cats[lib]["routines"]
        assert set(wire) == set(module.ROUTINES)
        for rn, fn in module.ROUTINES.items():
            assert specs.from_wire(wire[rn]) == specs.spec_of(fn, rn)
    # engine builtins are discoverable too
    assert "load_library" in cats[ENGINE_LIBRARY]["routines"]


def test_describe_single_library_and_unknown(ac):
    cats = ac._describe("skylark")
    assert set(cats) == {"skylark"}
    assert "cg_solve" in cats["skylark"]["routines"]
    with pytest.raises(AlchemistError, match="not registered.*elemental"):
        ac.library("nope")


def test_describe_requires_known_session(engine):
    res = protocol.decode_result(engine.describe(
        protocol.encode_describe(protocol.Describe(session=999))))
    assert "session #999" in res.error
    # same wire discipline as submit: the system session is not a client
    res0 = protocol.decode_result(engine.describe(
        protocol.encode_describe(protocol.Describe(session=0))))
    assert "system session" in res0.error


def test_libraries_lists_loaded(ac):
    libs = ac.libraries()
    assert {"elemental", "skylark", "mllib", ENGINE_LIBRARY} <= set(libs)


# ---- library façade -------------------------------------------------------
def test_facade_qr_tuple_unpacks_in_declared_order(ac):
    a = RNG.randn(96, 24).astype(np.float32)
    A = ac.send_matrix(a)
    Q, R = ac.library("elemental").qr(A)
    assert Q.is_deferred and R.is_deferred
    q, r = Q.to_numpy(), R.to_numpy()
    assert q.shape == (96, 24) and r.shape == (24, 24)
    np.testing.assert_allclose(q @ r, a, atol=1e-4)


def test_facade_single_output_returns_one_proxy(ac):
    G = ac.library("elemental").gram(ac.send_matrix(RNG.randn(32, 8)))
    assert isinstance(G, AlMatrix)
    assert G.shape == (8, 8)


def test_facade_positional_args_bind_by_declared_order(ac):
    a = ac.send_matrix(RNG.randn(16, 4).astype(np.float32))
    Q, R = ac.library("elemental").qr(a)      # positional A
    assert R.shape == (4, 4)


def test_facade_scalar_outputs_via_stats(ac):
    A = ac.send_matrix(RNG.randn(64, 16).astype(np.float32))
    U, S, V = ac.library("elemental").truncated_svd(A, k=4)
    st = S.stats()
    assert st["lanczos_iters"] >= 4 and st["matvecs"] >= 4
    assert "_exec_s" in st
    assert not any(isinstance(v, MatrixHandle) for v in st.values())


def test_facade_unknown_routine_lists_catalog(ac):
    el = ac.library("elemental")
    with pytest.raises(AttributeError, match="no routine 'svd'.*catalog:"):
        el.svd
    assert "qr" in dir(el)


def test_facade_unknown_kwarg_fails_pre_submit(ac, engine):
    el = ac.library("elemental")
    before = crossings(engine)
    with pytest.raises(specs.SpecError, match="unexpected keyword.*rank"):
        el.truncated_svd(A=ac.send_matrix(RNG.randn(8, 4)), rank=2)
    with pytest.raises(specs.SpecError, match="missing required"):
        el.multiply(A=ac.send_matrix(RNG.randn(4, 4)))
    with pytest.raises(specs.SpecError, match="expects int"):
        el.random_matrix(rows=8, cols=4, seed=1.5)
    with pytest.raises(specs.SpecError, match="engine-resident matrix"):
        el.qr(A=np.zeros((3, 3)))
    assert crossings(engine) == before      # nothing crossed the bridge


def test_facade_cross_session_proxy_rejected_client_side(ac, engine):
    other = AlchemistContext(engine=engine, client_name="other")
    foreign = other.send_matrix(RNG.randn(8, 4))
    el = ac.library("elemental")              # catalog fetched up front
    before = crossings(engine)
    with pytest.raises(AlchemistError, match="session-scoped"):
        el.qr(A=foreign)
    assert crossings(engine) == before
    other.stop()


def test_facade_mllib_baseline_runs_through_catalog(ac):
    x = RNG.randn(60, 6).astype(np.float32)
    y = RNG.randn(60, 2).astype(np.float32)
    W = ac.library("mllib").cg_solve(
        X=ac.send_matrix(x), Y=ac.send_matrix(y), lam=1e-3,
        max_iters=300, tol=1e-10)
    want = np.linalg.solve(x.T @ x + 60 * 1e-3 * np.eye(6), x.T @ y)
    np.testing.assert_allclose(W.to_numpy(), want, atol=1e-4)
    assert W.stats()["bsp_rounds"] >= 1


# ---- lazy chaining / zero intermediate round trips ------------------------
def test_deferred_chain_submits_with_zero_intermediate_round_trips(
        ac, engine):
    el = ac.library("elemental")
    A = ac.send_matrix(RNG.randn(24, 24).astype(np.float32))
    fetches_before = len(engine.transfer_log.records)
    before = dict(engine.endpoint_counts)
    x = A
    stages = 5
    for _ in range(stages):
        x = el.multiply(A=x, B=A)
    after = dict(engine.endpoint_counts)
    # exactly one submit per stage; no polls, waits, or fetches crossed
    assert after["submit"] - before.get("submit", 0) == stages
    assert after.get("task_op", 0) == before.get("task_op", 0)
    assert len(engine.transfer_log.records) == fetches_before
    # forcing costs exactly one wait
    x.result()
    assert engine.endpoint_counts["task_op"] == before.get("task_op", 0) + 1
    want = np.linalg.matrix_power(np.asarray(A.to_numpy()), stages + 1)
    np.testing.assert_allclose(x.to_numpy(), want, rtol=2e-2)


def test_operator_sugar_matches_numpy(ac):
    a = RNG.randn(12, 6).astype(np.float32)
    b = RNG.randn(6, 9).astype(np.float32)
    A, B = ac.send_matrix(a), ac.send_matrix(b)
    np.testing.assert_allclose((A @ B).to_numpy(), a @ b, atol=1e-5)
    np.testing.assert_allclose(A.T.to_numpy(), a.T, atol=1e-6)
    np.testing.assert_allclose((A + A).to_numpy(), a + a, atol=1e-6)
    # mixed deferred/concrete chain: (A @ B).T @ (A @ B)
    AB = A @ B
    np.testing.assert_allclose((AB.T @ AB).to_numpy(),
                               (a @ b).T @ (a @ b), atol=1e-3)


def test_operator_matmul_accepts_1d_vector_operand(ac):
    v = ac.send_matrix(RNG.randn(6).astype(np.float32))
    M = ac.send_matrix(RNG.randn(6, 3).astype(np.float32))
    np.testing.assert_allclose((v @ M).to_numpy(),
                               v.to_numpy() @ M.to_numpy(), atol=1e-5)


def test_operator_shape_mismatch_fails_client_side(ac, engine):
    A = ac.send_matrix(RNG.randn(4, 3))
    B = ac.send_matrix(RNG.randn(4, 3))
    C = ac.send_matrix(RNG.randn(2, 2))
    before = crossings(engine)
    with pytest.raises(AlchemistError, match="shape mismatch for @"):
        A @ B
    with pytest.raises(AlchemistError, match="shape mismatch for \\+"):
        A + C
    assert crossings(engine) == before
    # raw arrays never silently coerce, in either operand position
    with pytest.raises(TypeError):
        A @ np.zeros((3, 3))
    with pytest.raises(TypeError):
        np.zeros((5, 4)) @ A


def test_chaining_on_known_failed_producer_raises_immediately(ac):
    el = ac.library("elemental")
    ghost = AlMatrix.wrap(ac, MatrixHandle.fresh((3, 3), "float32"))
    bad = el.gram(A=ghost)                    # submits; fails engine-side
    with pytest.raises(AlchemistError):
        bad.result()
    # the failure is now known client-side: chaining fails fast, pre-submit
    with pytest.raises(AlchemistError, match="producer failed"):
        el.qr(A=bad)


def test_chaining_on_unfetched_failed_producer_fails_at_force(ac):
    el = ac.library("elemental")
    ghost = AlMatrix.wrap(ac, MatrixHandle.fresh((3, 3), "float32"))
    bad = el.gram(A=ghost)
    # chain before anyone observed the failure: the data edge carries it
    downstream = el.qr(A=bad)
    with pytest.raises(AlchemistError, match="upstream|KeyError"):
        downstream[0].result()


def test_legacy_call_accepts_deferred_almatrix(ac):
    el = ac.library("elemental")
    A = ac.send_matrix(RNG.randn(16, 8).astype(np.float32))
    G = el.gram(A)                            # deferred proxy
    res = ac.call("elemental", "qr", A=G)     # old API, new proxy
    assert res["R"].shape == (8, 8)


# ---- AlMatrix lifecycle ---------------------------------------------------
def test_wrap_and_legacy_constructor_shim(ac):
    a = RNG.randn(8, 4)
    legacy_data = AlMatrix(ac, a)             # old dual-mode: upload
    assert legacy_data.shape == (8, 4)
    h = legacy_data.handle
    legacy_handle = AlMatrix(ac, h)           # old dual-mode: wrap
    assert legacy_handle.handle is h
    assert AlMatrix.wrap(ac, h).handle is h
    assert AlMatrix.from_handle(ac, h).handle is h


def test_double_free_guarded(ac, engine):
    al = ac.send_matrix(RNG.randn(16, 16))
    h = al.handle
    engine.retain(h)                          # someone else's reference
    al.free()
    assert engine.refcount(h) == 1            # theirs survives
    with pytest.raises(AlchemistError, match="double free"):
        al.free()
    assert engine.refcount(h) == 1            # ...still survives
    with pytest.raises(AlchemistError, match="was freed"):
        al.to_numpy()


def test_freed_proxy_rejected_as_argument(ac):
    al = ac.send_matrix(RNG.randn(8, 4))
    al.free()
    with pytest.raises(AlchemistError, match="was freed"):
        ac.library("elemental").qr(A=al)


# ---- context manager & stop semantics -------------------------------------
def test_context_manager_stops_on_exit(engine):
    engine.load_library("elemental", elemental)
    with AlchemistContext(engine=engine) as ac:
        al = ac.send_matrix(RNG.randn(8, 8))
        assert engine.resident_bytes() > 0
        session = ac.session
    assert ac._stopped
    assert engine.resident_bytes() == 0       # reclaimed at disconnect
    with pytest.raises(AlchemistError):
        ac.call("elemental", "qr", A=al)
    assert all(s.id != session for s in engine.sessions())


def test_facade_call_on_stopped_context_fails_client_side(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    el = ac.library("elemental")
    A = ac.send_matrix(RNG.randn(4, 4))
    ac.stop()
    with pytest.raises(AlchemistError, match="stopped"):
        el.qr(A=A)              # same fail-fast as the legacy shim


def test_context_manager_stops_on_error(engine):
    with pytest.raises(ValueError):
        with AlchemistContext(engine=engine) as ac:
            raise ValueError("boom")
    assert ac._stopped


def test_post_stop_future_use_raises_clear_error(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    fetched = ac.call_async("elemental", "random_matrix", rows=4, cols=4)
    fetched.result()                          # fetched before stop: kept
    orphan = ac.call_async("elemental", "random_matrix", rows=4, cols=4,
                           seed=7)
    U = AlMatrix.deferred(ac, orphan, "A")
    ac.stop()
    assert fetched.result()["A"].shape == (4, 4)   # client-side cache
    for use in (orphan.result, orphan.state, orphan.done,
                lambda: orphan["A"], U.result, lambda: U.shape):
        with pytest.raises(AlchemistError, match="stopped before task"):
            use()


def test_post_stop_deferred_chain_arg_raises_clear_error(engine):
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    ac2 = AlchemistContext(engine=engine)
    orphan = AlMatrix.deferred(
        ac, ac.call_async("elemental", "random_matrix", rows=4, cols=4),
        "A")
    ac.stop()
    with pytest.raises(AlchemistError, match="stopped before task"):
        orphan._wire_arg()
    ac2.stop()
