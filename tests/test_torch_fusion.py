"""The port's chain fusion (``repro_torch.core``: ``scheduler.claim_chain``,
``engine._run_fused``, ``TorchBackend.compile``) under the tests of
``tests/test_fusion.py``, test for test, over both bridges, then the torch
backend's capture decision and program cache as functions of a plan. On
the CPU a fused plan runs eagerly in one task; capturing it into a CUDA
graph needs the card (``tests/test_torch_cuda.py``).

JIT chain fusion: burst-submitted dependency chains execute as ONE
fused backend program — correctness vs eager execution, scheduler-hazard
interaction, failure semantics, cache-fingerprint identity fused vs
unfused, and the cost-model accounting (`TaskLog.stats()`)."""
import numpy as np
import pytest
import torch

from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.backends import base as bb
from repro_torch.core.backends import torch_backend
from repro_torch.core.context import AlchemistError
from repro_torch.core.libraries import elemental
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)

RNG = np.random.RandomState(3)
A = (RNG.randn(16, 16) / 4.0).astype(np.float32)


def fresh(cache_entries=0, fuse_chains=True, **ctx_kw):
    engine = AlchemistEngine(device="cpu",
                             cache_entries=cache_entries,
                             fuse_chains=fuse_chains)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine, **ctx_kw)
    return engine, ac


def burst_chain(engine, ac, al, stages):
    """Submit a multiply chain in one burst (scheduler paused so the
    whole chain lands in the table before dispatch — deterministic
    claiming), force, and return the proxies. The engine is passed in:
    over the socket bridge ``ac.engine`` is the client's bridge."""
    el = ac.library("elemental")
    engine.scheduler.pause()
    xs = [al]
    for _ in range(stages):
        xs.append(el.multiply(A=xs[-1], B=al))
    engine.scheduler.resume()
    xs[-1].result()
    return xs


def chain_power(a, stages):
    want = a
    for _ in range(stages):
        want = want @ a
    return want


# ---------------------------------------------------------------------------
# the headline: one dispatch for the whole chain
# ---------------------------------------------------------------------------
def test_burst_chain_fuses_into_one_dispatched_task():
    engine, ac = fresh()
    try:
        al = ac.send_matrix(A)
        before = engine.task_log.stats()
        xs = burst_chain(engine, ac, al, 4)
        stats = engine.task_log.stats()
        assert stats["dispatched"] - before["dispatched"] == 1
        assert stats["absorbed"] - before["absorbed"] == 3
        assert stats["fused_tasks"] == 1 and stats["fused_ops"] == 4
        np.testing.assert_allclose(xs[-1].to_numpy(), chain_power(A, 4),
                                   rtol=1e-3, atol=1e-5)
    finally:
        ac.stop()
        engine.shutdown()


def test_fused_matches_eager_per_op_results():
    engine_f, ac_f = fresh()
    engine_e, ac_e = fresh()
    try:
        out_f = burst_chain(engine_f, ac_f, ac_f.send_matrix(A), 5)[-1].to_numpy()
        assert engine_f.task_log.stats()["fused_tasks"] == 1
        # eager: one blocking call per op — never fuses
        al = ac_e.send_matrix(A)
        x = al
        for _ in range(5):
            x = ac_e.wrap(ac_e.call("elemental", "multiply",
                                    A=x, B=al)["C"])
        assert engine_e.task_log.stats()["fused_tasks"] == 0
        np.testing.assert_allclose(out_f, x.to_numpy(), rtol=1e-4,
                                   atol=1e-5)
    finally:
        ac_f.stop()
        engine_f.shutdown()
        ac_e.stop()
        engine_e.shutdown()


def test_intermediate_outputs_of_fused_chain_are_real():
    """Absorbed commands still deliver: every intermediate proxy forces
    to the correct value (clients may hold any of them)."""
    engine, ac = fresh()
    try:
        xs = burst_chain(engine, ac, ac.send_matrix(A), 3)
        for i, x in enumerate(xs[1:], start=1):
            np.testing.assert_allclose(x.to_numpy(), chain_power(A, i),
                                       rtol=1e-3, atol=1e-5)
            assert x.future.state() == "DONE"
    finally:
        ac.stop()
        engine.shutdown()


def test_mixed_op_chain_fuses():
    engine, ac = fresh()
    try:
        el = ac.library("elemental")
        al = ac.send_matrix(A)
        engine.scheduler.pause()
        c1 = el.multiply(A=al, B=al)
        c2 = el.transpose(A=c1)
        c3 = el.add(A=c2, B=al)
        engine.scheduler.resume()
        got = c3.to_numpy()
        stats = engine.task_log.stats()
        assert stats["fused_tasks"] == 1 and stats["fused_ops"] == 3
        np.testing.assert_allclose(got, (A @ A).T + A, rtol=1e-4,
                                   atol=1e-5)
    finally:
        ac.stop()
        engine.shutdown()


def test_fusion_toggles():
    # per-session opt-out
    engine, ac = fresh(fusion=False)
    try:
        burst_chain(engine, ac, ac.send_matrix(A), 3)
        assert engine.task_log.stats()["fused_tasks"] == 0
    finally:
        ac.stop()
        engine.shutdown()
    # engine-wide kill switch
    engine, ac = fresh(fuse_chains=False)
    try:
        burst_chain(engine, ac, ac.send_matrix(A), 3)
        assert engine.task_log.stats()["fused_tasks"] == 0
    finally:
        ac.stop()
        engine.shutdown()
    # reference backend never fuses (no fused program to build)
    engine, ac = fresh(backend="reference")
    try:
        xs = burst_chain(engine, ac, ac.send_matrix(A), 3)
        assert engine.task_log.stats()["fused_tasks"] == 0
        np.testing.assert_allclose(xs[-1].to_numpy(), chain_power(A, 3),
                                   rtol=1e-3, atol=1e-5)
    finally:
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# scheduler hazards: fusion must never reorder against a write
# ---------------------------------------------------------------------------
def test_interleaved_write_hazard_breaks_claim_and_keeps_order():
    """A write on the chain's leaf between two chain submissions must
    execute between them, fused or not: the writer's hazard edge stops
    the claim, and the results match eager per-op execution."""
    def scale(eng, M, factor: float = 2.0):
        eng.overwrite(M, eng.get(M) * factor)
        return {"M": M}
    scale.writes = ("M",)

    class _W:
        ROUTINES = {"scale": scale}

    engine, ac = fresh()
    engine.load_library("w", _W)
    try:
        el = ac.library("elemental")
        al = ac.send_matrix(A)
        engine.scheduler.pause()
        m1 = el.multiply(A=al, B=al)          # reads old leaf
        f_scale = ac.call_async("w", "scale", M=al, factor=2.0)
        m2 = el.multiply(A=m1, B=al)          # reads *scaled* leaf
        engine.scheduler.resume()
        got1, got2 = m1.to_numpy(), m2.to_numpy()
        f_scale.result()
        # eager semantics: m1 = A@A, then leaf *= 2, m2 = (A@A) @ (2A)
        np.testing.assert_allclose(got1, A @ A, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got2, (A @ A) @ (2.0 * A),
                                   rtol=1e-4, atol=1e-4)
        # the write sat between the two ops, so nothing fused across it
        assert engine.task_log.stats()["fused_tasks"] == 0
    finally:
        ac.stop()
        engine.shutdown()


def test_other_sessions_overwrite_of_shared_store_is_isolated():
    """The cross-session variant: another tenant overwrites its alias of
    the chain's leaf store (minted by upload dedup) mid-burst. Copy-on-
    write isolates the chain either way — results equal eager."""
    def zero(eng, M):
        eng.overwrite(M, torch.zeros(tuple(M.shape), dtype=torch.float32))
        return {"M": M}
    zero.writes = ("M",)

    class _W:
        ROUTINES = {"zero": zero}

    engine, ac_a = fresh()
    engine.load_library("w", _W)
    ac_b = AlchemistContext(engine=engine)
    try:
        al_a = ac_a.send_matrix(A)
        al_b = ac_b.send_matrix(A)        # dedup: alias of the same store
        engine.scheduler.pause()
        el = ac_a.library("elemental")
        x = el.multiply(A=al_a, B=al_a)
        y = el.multiply(A=x, B=al_a)
        fz = ac_b.call_async("w", "zero", M=al_b)
        engine.scheduler.resume()
        np.testing.assert_allclose(y.to_numpy(), chain_power(A, 2),
                                   rtol=1e-4, atol=1e-5)
        fz.result()
        np.testing.assert_allclose(
            np.asarray(engine.get(al_b.handle, session=ac_b.session)),
            np.zeros_like(A))
        np.testing.assert_allclose(
            np.asarray(engine.get(al_a.handle, session=ac_a.session)),
            A, rtol=1e-6)
    finally:
        ac_b.stop()
        ac_a.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# failure semantics
# ---------------------------------------------------------------------------
def test_fused_chain_failure_matches_eager_semantics():
    """A mid-chain shape error: steps before it succeed, the broken step
    fails with the routine's error, later steps fail as upstream
    casualties — exactly like unfused dispatch."""
    engine, ac = fresh()
    try:
        rect = RNG.randn(16, 8).astype(np.float32)
        al = ac.send_matrix(rect)
        el = ac.library("elemental")
        engine.scheduler.pause()
        t = el.transpose(A=al)               # (8, 16) — fine
        bad = el.multiply(A=t, B=t)          # (8,16) @ (8,16) — breaks
        worse = el.multiply(A=bad, B=bad)    # upstream casualty
        engine.scheduler.resume()
        np.testing.assert_allclose(t.to_numpy(), rect.T, rtol=1e-6)
        with pytest.raises(AlchemistError):
            bad.result()
        with pytest.raises(AlchemistError, match="upstream"):
            worse.result()
    finally:
        ac.stop()
        engine.shutdown()


def test_fused_delivery_failure_never_strands_claimed_tasks():
    """An implementation that violates the output contract (returns a
    non-dict) after the fused program ran must fail the claimed tasks —
    never leave them RUNNING forever (waiters would hang)."""
    engine, ac = fresh()
    jaxb = engine.backends["torch"]
    jaxb._impls[("badlib", "ok")] = bb.RoutineImpl(
        fn=lambda A: {"C": A + 1.0}, fusible=True)
    jaxb._impls[("badlib", "boom")] = bb.RoutineImpl(
        fn=lambda A: A * 2.0, fusible=True)      # contract violation

    class _L:
        ROUTINES = {"ok": lambda eng, A: {}, "boom": lambda eng, A: {}}

    engine.load_library("badlib", _L)
    try:
        al = ac.send_matrix(A)
        engine.scheduler.pause()
        f1 = ac.call_async("badlib", "ok", A=al)
        f2 = ac.call_async("badlib", "boom", A=f1["C"])
        engine.scheduler.resume()
        # the lead's own step delivered: eager semantics, it succeeds
        np.testing.assert_allclose(
            np.asarray(engine.get(f1.result()["C"],
                                  session=ac.session)),
            A + 1.0, rtol=1e-6)
        with pytest.raises(AlchemistError):      # and this returns, no hang
            f2.result()
    finally:
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# cache: fused and unfused runs are indistinguishable to the cache
# ---------------------------------------------------------------------------
def test_cache_fingerprints_identical_fused_vs_unfused():
    engine_f, ac_f = fresh(cache_entries=64)
    engine_e, ac_e = fresh(cache_entries=64)
    try:
        xs = burst_chain(engine_f, ac_f, ac_f.send_matrix(A), 3)
        assert engine_f.task_log.stats()["fused_tasks"] == 1

        x = ac_e.send_matrix(A)
        eager = [x]
        for _ in range(3):
            x = ac_e.wrap(ac_e.call("elemental", "multiply", A=x,
                                    B=eager[0])["C"])
            eager.append(x)
        assert engine_e.task_log.stats()["fused_tasks"] == 0

        for fused_m, eager_m in zip(xs, eager):
            fp_f = engine_f.fingerprint(fused_m.handle)
            fp_e = engine_e.fingerprint(eager_m.handle)
            assert fp_f == fp_e, (fp_f, fp_e)
            assert fp_f.startswith(("c:", "r:"))
    finally:
        ac_f.stop()
        engine_f.shutdown()
        ac_e.stop()
        engine_e.shutdown()


def test_warm_chain_is_served_from_cache_without_dispatch():
    engine, ac = fresh(cache_entries=64)
    try:
        burst_chain(engine, ac, ac.send_matrix(A), 3)
        before = engine.task_log.stats()
        xs = burst_chain(engine, ac, ac.send_matrix(A), 3)  # dedup + fast path
        after = engine.task_log.stats()
        assert after["dispatched"] == before["dispatched"]
        assert after["absorbed"] == before["absorbed"]
        np.testing.assert_allclose(xs[-1].to_numpy(), chain_power(A, 3),
                                   rtol=1e-3, atol=1e-5)
    finally:
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# the torch backend's capture decision and program cache, as functions of a
# plan (capture itself needs the card: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------
def _plan(backend, *steps):
    """An ExecutionPlan of ``(routine, args)`` steps of the elemental
    library, with this backend's own implementations."""
    return bb.ExecutionPlan(steps=[
        bb.PlanStep(library="elemental", routine=r, args=dict(args),
                    impl=backend.routine_impl("elemental", r))
        for r, args in steps])


def _linear_chain(backend):
    return _plan(backend,
                 ("multiply", {"A": bb.Input("i0"), "B": bb.Input("i0")}),
                 ("transpose", {"A": bb.StepRef(0, "C")}),
                 ("add", {"A": bb.StepRef(1, "C"), "B": bb.Input("i0")}),
                 ("gram", {"A": bb.StepRef(2, "C")}),
                 ("replicate_cols", {"A": bb.StepRef(3, "G"), "times": 2}))


HOST_STEPS = {
    # random_matrix draws on the host and hands back a CPU tensor
    "random_matrix": [("random_matrix", {"rows": 16, "cols": 16}),
                      ("multiply", {"A": bb.StepRef(0, "A"),
                                    "B": bb.Input("i0")})],
    # qr and gram_svd check LAPACK's info on the host (a sync)
    "qr": [("qr", {"A": bb.Input("i0")}),
           ("multiply", {"A": bb.StepRef(0, "Q"), "B": bb.StepRef(0, "R")})],
    "gram_svd": [("gram_svd", {"A": bb.Input("i0"), "k": 4}),
                 ("transpose", {"A": bb.StepRef(0, "V")}),
                 ("multiply", {"A": bb.StepRef(0, "U"),
                               "B": bb.StepRef(1, "C")})],
}


def test_a_linear_chain_is_marked_for_capture():
    be = torch_backend.TorchBackend()
    assert be.capturable(_linear_chain(be))
    assert torch_backend.CAPTURE_SAFE == {
        ("elemental", r) for r in ("multiply", "add", "transpose", "gram",
                                   "replicate_cols")}


@pytest.mark.parametrize("host_step", sorted(HOST_STEPS))
def test_a_plan_holding_a_host_step_is_not_captured(host_step):
    be = torch_backend.TorchBackend()
    plan = _plan(be, *HOST_STEPS[host_step])
    assert not be.capturable(plan)
    # every one of them stays fusible: the catalogs do not change
    assert all(s.impl.fusible for s in plan.steps)
    # and the plan still runs, eagerly, in one call of its program
    outs = be.compile(plan)({"i0": torch.from_numpy(A.copy())})
    assert len(outs) == len(plan.steps)


def test_one_step_unhashable_or_foreign_plans_are_not_captured():
    be = torch_backend.TorchBackend()
    assert not be.capturable(_plan(
        be, ("multiply", {"A": bb.Input("i0"), "B": bb.Input("i0")})))
    unhashable = _linear_chain(be)
    unhashable.steps[4].args["times"] = [2]
    assert not be.capturable(unhashable)
    foreign = _linear_chain(be)
    foreign.steps[0].impl = bb.RoutineImpl(fn=lambda A, B: {"C": A @ B},
                                           fusible=True)
    assert not be.capturable(foreign)


@pytest.mark.parametrize("host_step", sorted(HOST_STEPS))
def test_a_burst_chain_with_a_host_step_runs_as_one_task(host_step):
    engine, ac = fresh()
    try:
        el = ac.library("elemental")
        al = ac.send_matrix(A)
        engine.scheduler.pause()
        if host_step == "random_matrix":
            r = el.random_matrix(rows=16, cols=16, seed=5)
            out = el.multiply(A=r, B=al)
            want = np.random.default_rng(5).standard_normal(
                (16, 16)).astype(np.float32) @ A
        elif host_step == "qr":
            q, r = el.qr(A=al)
            out = el.multiply(A=q, B=r)
            want = A
        else:
            u, s, v = el.gram_svd(A=al, k=4)
            out = el.multiply(A=u, B=el.transpose(A=v))
            vk = np.linalg.svd(A.astype(np.float64))[2][:4]
            want = vk.T @ vk        # (U V^T)^T (U V^T) = V V^T, sign-free
        engine.scheduler.resume()
        got = out.to_numpy()
        stats = engine.task_log.stats()
        assert stats["dispatched"] == 1
        assert stats["fused_tasks"] == 1
        assert stats["fused_ops"] == len(HOST_STEPS[host_step])
        if host_step == "gram_svd":
            np.testing.assert_allclose(got.T @ got, want, rtol=1e-3,
                                       atol=1e-3)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    finally:
        ac.stop()
        engine.shutdown()


def test_the_program_key_follows_shape_stride_dtype_and_address():
    be = torch_backend.TorchBackend()
    plan = _linear_chain(be)
    x = torch.from_numpy(A.copy())
    key = torch_backend.program_key(plan, {"i0": x})
    assert key == torch_backend.program_key(plan, {"i0": x})
    assert key == torch_backend.program_key(plan, {"i0": x.view(16, 16)})
    others = {
        "shape": x[:8],                                  # same address
        "stride": x.t(),                                 # same address
        "dtype": x.view(torch.int32),                    # same address
        "address": x.clone(),
    }
    keys = {k: torch_backend.program_key(plan, {"i0": t})
            for k, t in others.items()}
    assert others["shape"].data_ptr() == x.data_ptr()
    for what, k in keys.items():
        assert k != key, what
    assert len(set(keys.values())) == len(keys)
    # the plan's structure and scalars are part of the key too
    other_plan = _linear_chain(be)
    other_plan.steps[4].args["times"] = 3
    assert torch_backend.program_key(other_plan, {"i0": x}) != key


class _StubProgram:
    """Stands in for a captured program (capture needs a card)."""

    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


def test_the_program_lru_drops_and_releases_its_oldest_past_its_bound():
    be = torch_backend.TorchBackend()
    be.max_programs = 2                  # as program_cache_size sets it
    progs = {k: _StubProgram() for k in "abc"}
    be._cache_put("a", progs["a"])
    be._cache_put("b", progs["b"])
    assert be._cache_get("a") is progs["a"]      # "a" is now the newest
    be._cache_put("c", progs["c"])
    assert be._cache_get("b") is None and progs["b"].released
    assert not progs["a"].released and not progs["c"].released
    # the stubs hold no device bytes, and on the CPU no byte bound applies
    assert be.program_cache_info() == {"programs": 2, "max_programs": 2,
                                       "held_bytes": 0,
                                       "max_program_bytes": None,
                                       "evictions": 1}
    be.release()
    assert progs["a"].released and progs["c"].released
    assert be.program_cache_info()["programs"] == 0
    assert torch_backend.DEFAULT_MAX_PROGRAMS == 128
    assert torch_backend.TorchBackend().max_programs == 128


def test_engine_shutdown_releases_the_captured_programs():
    engine = AlchemistEngine(device="cpu")
    prog = _StubProgram()
    engine.backends["torch"]._cache_put("k", prog)
    engine.shutdown()
    assert prog.released
    assert engine.backends["torch"].program_cache_info()["programs"] == 0


def test_launches_inside_a_capture_are_recorded_not_counted():
    from repro_torch.kernels import device
    counter = device.LaunchCounter()
    counter.add()
    with device.capturing_launches() as recorded:
        counter.add()
        counter.add()
    assert counter.value == 1 and recorded == {counter: 2}
    counter.add(recorded[counter])               # what a replay adds
    assert counter.value == 3
    with pytest.raises(RuntimeError):
        with device.capturing_launches():
            with device.capturing_launches():
                pass
    counter.add()
    assert counter.value == 4                    # the context was left
