"""The port's multi-tenant QoS (``repro_torch.core.qos``) under the tests of
``tests/test_qos.py``, test for test, over both bridges, with chain fusion
on and the port's lifecycle monitor armed, as ``tests/conftest.py`` arms
the JAX package's.

Multi-tenant QoS: fair-share dispatch, admission control, and
end-to-end backpressure (core/qos; ROADMAP item 2).

The policy/admission unit tests poke ``core/qos`` directly; the
integration tests run — like every protocol suite — over both the
in-memory bridge and real TCP (see conftest ``_BRIDGED_SUITES``), so the
typed busy error and its ``retry_after_s`` hint are proven to survive
the socket crossing.
"""
import collections
import threading
import types

import numpy as np
import pytest

from repro_torch.core import AlchemistBusyError, AlchemistContext, \
    AlchemistEngine, AlchemistError
from repro_torch.core.libraries import elemental
from repro_torch.core.qos import AdmissionController, FairShareQueue, \
    FifoReadyQueue, QuotaConfig
from torch_bridge import bridge_mode  # noqa: F401  (every test, 2 bridges)
from torch_bridge import stm_monitor  # noqa: F401  (armed for every test)


def _task(tid, session, price=0.0, exec_s=0.0, wait_s=0.0):
    return types.SimpleNamespace(id=tid, session=session, price=price,
                                 exec_s=exec_s, wait_s=wait_s)


def _qos_engine(**kw):
    kw.setdefault("qos", True)
    return AlchemistEngine(device="cpu", scheduler_workers=1, **kw)


def _context(engine, **kw):
    ac = AlchemistContext(engine=engine, **kw)
    ac.register_library("elemental", elemental)
    return ac


# ---------------------------------------------------------------------------
# policy unit tests
# ---------------------------------------------------------------------------
class TestFifoIdentity:
    def test_order_matches_plain_deque(self):
        q = FifoReadyQueue()
        ref = collections.deque()
        for tid in [5, 3, 9, 1]:
            q.push(_task(tid, session=tid % 2))
            ref.append(tid)
        assert len(q) == 4 and bool(q)
        assert [q.pop() for _ in range(4)] == list(ref)
        assert len(q) == 0 and not q

    def test_qos_hooks_are_noops(self):
        q = FifoReadyQueue()
        q.push(_task(1, session=7))
        q.task_done(_task(1, session=7, exec_s=3.0))
        q.set_weight(7, 100.0)
        assert q.should_yield(7) is False
        q.forget_session(99)
        assert q.pop() == 1


class TestFairShare:
    def test_light_tenant_wins_against_expensive_queue(self):
        # heavy session 1 queues pricey tasks; light session 2 cheap ones.
        # After the tie-broken first pick, the light tenant should land
        # several dispatches before the heavy one's clock comes back down.
        q = FairShareQueue()
        for tid in (10, 11, 12):
            q.push(_task(tid, session=1, price=1.0))
        for tid in (20, 21, 22):
            q.push(_task(tid, session=2, price=0.1))
        order = [q.pop() for _ in range(6)]
        # vtime tie at 0 -> session 1 (lower id) pops once, charging 1.0;
        # session 2 then drains fully (0.1 steps) before session 1 again
        assert order == [10, 20, 21, 22, 11, 12]

    def test_weights_scale_the_share(self):
        q = FairShareQueue()
        q.set_weight(1, 2.0)
        q.set_weight(2, 1.0)
        for tid in range(100, 110):
            q.push(_task(tid, session=1, price=1.0))
        for tid in range(200, 210):
            q.push(_task(tid, session=2, price=1.0))
        picks = [q.pop() for _ in range(9)]
        share_1 = sum(1 for t in picks if t < 200)
        # equal prices, weight 2:1 -> session 1 gets ~2/3 of the picks
        assert share_1 == 6

    def test_idle_session_earns_no_credit(self):
        q = FairShareQueue()
        q.push(_task(1, session=1, price=1.0))
        assert q.pop() == 1               # clock -> 0, vtime(1) -> 1.0
        q.push(_task(2, session=1, price=1.0))
        assert q.pop() == 2               # clock -> 1.0, vtime(1) -> 2.0
        # session 2 was idle the whole time: its vtime floors to the
        # clock (1.0), not 0 — it gets the next pick but cannot burst
        # arbitrarily on a stale low clock
        q.push(_task(3, session=2, price=1.0))
        assert q._vtime[2] == pytest.approx(1.0)

    def test_task_done_reconciles_debt(self):
        q = FairShareQueue()
        q.push(_task(1, session=1, price=0.1))
        q.pop()
        v_after_charge = q._vtime[1]
        # measured exec 10x the estimate: the difference lands as debt
        q.task_done(_task(1, session=1, price=0.1, exec_s=1.0))
        assert q._vtime[1] == pytest.approx(v_after_charge + 0.9)

    def test_task_done_unknown_task_is_noop(self):
        q = FairShareQueue()
        q.task_done(_task(42, session=1, exec_s=9.0))  # claimed-chain case
        assert q._vtime == {}

    def test_should_yield_only_for_trailing_ready_work(self):
        q = FairShareQueue(yield_threshold_s=0.05)
        q.push(_task(1, session=1, price=1.0))
        q.pop()                           # vtime(1)=1.0, nothing else ready
        assert not q.should_yield(1)      # no other session has work
        q.push(_task(2, session=2, price=0.1))
        assert q.should_yield(1)          # session 2 ready, trails by ~1.0
        assert not q.should_yield(2)      # the trailing side never yields

    def test_forget_session_drops_queue_and_clock(self):
        q = FairShareQueue()
        q.push(_task(1, session=1, price=1.0))
        q.push(_task(2, session=2, price=1.0))
        q.forget_session(1)
        assert len(q) == 1
        assert q.depths() == {2: 1}
        assert q.pop() == 2


# ---------------------------------------------------------------------------
# admission unit tests
# ---------------------------------------------------------------------------
class TestAdmission:
    def test_queue_depth_quota(self):
        ctl = AdmissionController(QuotaConfig(max_queue_depth=2))
        assert ctl.admit_submit(1, 1.0, queue_depth=1,
                                resident_bytes=0) is None
        denial = ctl.admit_submit(1, 1.0, queue_depth=2, resident_bytes=0)
        assert denial is not None
        reason, retry = denial
        assert "queue depth" in reason
        assert 0.05 <= retry <= 5.0

    def test_resident_bytes_quota(self):
        ctl = AdmissionController(QuotaConfig(max_resident_bytes=100))
        assert ctl.admit_submit(1, 1.0, queue_depth=0,
                                resident_bytes=100) is None
        denial = ctl.admit_submit(1, 1.0, queue_depth=0,
                                  resident_bytes=101)
        assert denial is not None and "resident" in denial[0]

    def test_no_quota_admits_everything(self):
        ctl = AdmissionController()
        assert ctl.admit_submit(1, 1.0, queue_depth=10 ** 6,
                                resident_bytes=10 ** 15) is None

    def test_per_session_override(self):
        ctl = AdmissionController(QuotaConfig(max_queue_depth=10))
        ctl.set_quota(2, {"max_queue_depth": 1})
        assert ctl.admit_submit(1, 1.0, queue_depth=5,
                                resident_bytes=0) is None
        assert ctl.admit_submit(2, 1.0, queue_depth=5,
                                resident_bytes=0) is not None
        assert ctl.quota_for(2).max_queue_depth == 1
        assert ctl.quota_for(1).max_queue_depth == 10

    def test_upload_reserve_release(self):
        ctl = AdmissionController(QuotaConfig(max_inflight_bytes=1000))
        assert ctl.reserve_upload(1, 600) is None
        assert ctl.inflight_bytes(1) == 600
        denial = ctl.reserve_upload(1, 600)
        assert denial is not None and "in-flight" in denial[0]
        assert ctl.inflight_bytes(1) == 600   # nothing reserved on denial
        ctl.release_upload(1, 600)
        assert ctl.inflight_bytes(1) == 0
        assert ctl.reserve_upload(1, 1000) is None

    def test_forget_session_reclaims_reservations(self):
        ctl = AdmissionController(QuotaConfig(max_inflight_bytes=1000))
        ctl.reserve_upload(1, 800)
        ctl.set_quota(1, {"max_queue_depth": 1})
        assert ctl.forget_session(1) == 800
        assert ctl.inflight_bytes(1) == 0
        assert ctl.quota_for(1).max_queue_depth is None

    def test_retry_hint_scales_with_depth(self):
        hint = AdmissionController._retry_hint
        assert hint(0, 0.0) == pytest.approx(0.05)
        assert hint(4, 0.5) == pytest.approx(2.0)
        assert hint(10 ** 6, 10.0) == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# engine integration (runs over both bridges)
# ---------------------------------------------------------------------------
class TestEngineQos:
    def test_over_quota_submit_raises_typed_busy_error(self):
        eng = _qos_engine(qos_quotas={"max_queue_depth": 1})
        try:
            ac = _context(eng, busy_retries=0)
            el = ac.library("elemental")
            a = ac.send_matrix(np.random.default_rng(0).normal(
                size=(32, 8)))
            eng.scheduler.pause()
            try:
                f1 = el.transpose(A=a)    # depth 0 -> admitted, queues
                with pytest.raises(AlchemistBusyError) as ei:
                    el.gram(A=a)          # depth 1 -> at quota, denied
                assert ei.value.retry_after_s > 0
                assert "queue depth" in str(ei.value)
            finally:
                eng.scheduler.resume()
            assert f1.to_numpy().shape == (8, 32)
            stats = eng.qos_stats()
            assert stats["rejected"] >= 1 and stats["admitted"] >= 1
            # the same accounting is wire-reachable as an engine builtin
            wire_stats = ac.call("_engine", "qos_stats")
            assert wire_stats["enabled"] is True
            assert wire_stats["rejected"] >= 1
            assert "ready_depths" in wire_stats
            ac.stop()
        finally:
            eng.shutdown()

    def test_busy_submit_retries_until_capacity_frees(self):
        eng = _qos_engine(qos_quotas={"max_queue_depth": 1})
        try:
            ac = _context(eng, busy_retries=8)
            el = ac.library("elemental")
            a = ac.send_matrix(np.ones((16, 4)))
            eng.scheduler.pause()
            f1 = el.transpose(A=a)
            t = threading.Timer(0.15, eng.scheduler.resume)
            t.start()
            try:
                # blocks in the client backoff loop until the timer
                # resumes the scheduler and the queue drains
                f2 = el.gram(A=a)
            finally:
                t.join()
            assert f1.to_numpy().shape == (4, 16)
            assert f2.to_numpy().shape == (4, 4)
            ac.stop()
        finally:
            eng.shutdown()

    def test_upload_backpressure_over_socket(self, bridge_mode):
        # in-flight upload reservations are the *server's* staging
        # quota: the in-memory bridge never stages, so only the socket
        # run exercises them
        if bridge_mode != "socket":
            pytest.skip("upload staging backpressure is wire-only")
        eng = _qos_engine(qos_quotas={"max_inflight_bytes": 1024})
        try:
            ac = _context(eng)
            with pytest.raises(AlchemistBusyError) as ei:
                ac.send_matrix(np.ones((64, 64)))   # 32 KiB > 1 KiB quota
            assert ei.value.retry_after_s > 0
            assert eng.qos_stats()["throttled"] >= 1
            # nothing leaked: a small upload still fits afterwards
            small = ac.send_matrix(np.ones((4, 4)))
            assert small.to_numpy().shape == (4, 4)
            assert eng.admission.inflight_bytes(ac.session) == 0
            ac.stop()
        finally:
            eng.shutdown()

    def test_fair_share_preempts_heavy_tenant(self):
        # one worker: the heavy SVD holds it while the light tenant's
        # task sits ready — the iteration-boundary yield_check must fire
        eng = _qos_engine(qos_yield_threshold_s=1e-6)
        try:
            heavy = _context(eng, backend="reference")
            light = _context(eng, backend="reference")
            el_h = heavy.library("elemental")
            el_l = light.library("elemental")
            a = heavy.send_matrix(np.random.default_rng(1).normal(
                size=(512, 64)))
            b = light.send_matrix(np.ones((16, 4)))
            eng.scheduler.pause()
            # the register_library barrier tasks above left the two
            # sessions at unequal virtual times; zero the clocks (under
            # the scheduler lock, like every policy mutation) so the pop
            # order below is deterministic: the SVD dispatches first and
            # the light task waits ready behind it
            with eng.scheduler._cv:
                eng._qos_policy._vtime.clear()
                eng._qos_policy._clock = 0.0
            svd = el_h.truncated_svd(A=a, k=8)
            g = el_l.gram(A=b)
            eng.scheduler.resume()
            assert svd[1].to_numpy().shape == (8,)
            assert g.to_numpy().shape == (4, 4)
            assert eng.qos_stats()["preempted"] >= 1
            heavy.stop()
            light.stop()
        finally:
            eng.shutdown()

    def test_configure_weight_and_quotas_echoed(self):
        eng = _qos_engine()
        try:
            ac = _context(eng)
            eff = ac.configure(weight=3.0,
                               quotas={"max_queue_depth": 7})
            assert eff["weight"] == pytest.approx(3.0)
            assert eff["quotas"]["max_queue_depth"] == 7
            assert eff["quotas"]["max_inflight_bytes"] is None
            ac.stop()
        finally:
            eng.shutdown()

    def test_configure_rejects_bad_qos_options(self):
        eng = _qos_engine()
        try:
            ac = _context(eng)
            with pytest.raises(AlchemistError):
                ac.configure(weight=0)
            with pytest.raises(AlchemistError):
                ac.configure(weight=-2.0)
            with pytest.raises(AlchemistError):
                ac.configure(quotas={"max_queue_depth": -1})
            with pytest.raises(AlchemistError):
                ac.configure(quotas={"bogus_knob": 3})
            ac.stop()
        finally:
            eng.shutdown()

    def test_disconnect_reclaims_qos_state(self):
        eng = _qos_engine(qos_quotas={"max_inflight_bytes": 10 ** 6})
        try:
            ac = _context(eng)
            sid = ac.session
            ac.configure(weight=5.0)
            eng.admission.reserve_upload(sid, 500)
            ac.stop()
            assert eng.admission.inflight_bytes(sid) == 0
            assert eng.admission.quota_for(sid) == eng.admission.defaults
        finally:
            eng.shutdown()


# ---------------------------------------------------------------------------
# default-off identity
# ---------------------------------------------------------------------------
class TestQosDisabled:
    def test_defaults_off_and_fifo_policy(self):
        eng = AlchemistEngine(device="cpu")
        try:
            assert eng.qos_enabled is False
            assert eng.admission is None
            assert isinstance(eng.scheduler._ready, FifoReadyQueue)
            stats = eng.qos_stats()
            assert stats["enabled"] is False
            assert stats["admitted"] == 0 and stats["rejected"] == 0
        finally:
            eng.shutdown()

    def test_quotas_without_qos_is_a_constructor_error(self):
        with pytest.raises(ValueError):
            AlchemistEngine(device="cpu",
                            qos_quotas={"max_queue_depth": 4})

    def test_configure_weight_rejected_when_disabled(self):
        eng = AlchemistEngine(device="cpu")
        try:
            ac = _context(eng)
            with pytest.raises(AlchemistError):
                ac.configure(weight=2.0)
            with pytest.raises(AlchemistError):
                ac.configure(quotas={"max_queue_depth": 4})
            # and the default-off configure echo carries no QoS keys
            eff = ac.configure(fusion=True)
            assert "weight" not in eff and "quotas" not in eff
            ac.stop()
        finally:
            eng.shutdown()


# ---------------------------------------------------------------------------
# warmup surface (satellite: explicit no-op on eager backends)
# ---------------------------------------------------------------------------
class TestWarmupSurface:
    def test_reference_backend_warmup_is_explicit_noop(self):
        eng = AlchemistEngine(device="cpu")
        try:
            stats = eng.warmup(backend="reference")
            assert stats["skipped"] is True
            assert "no AOT compile surface" in stats["reason"]
            assert stats["compiled"] == 0 and stats["replayed"] == 0
            assert eng.compile_log.stats()["warmup_compiles"] == 0
        finally:
            eng.shutdown()

    def test_unknown_backend_warmup_reports_why(self):
        eng = AlchemistEngine(device="cpu")
        try:
            stats = eng.warmup(backend="not-a-backend")
            assert stats["skipped"] is True
            assert "not registered" in stats["reason"]
        finally:
            eng.shutdown()

    def test_torch_backend_warmup_compiles(self):
        eng = AlchemistEngine(device="cpu")
        try:
            stats = eng.warmup(backend="torch", grid=(32,))
            assert stats["skipped"] is False and stats["reason"] == ""
            assert stats["compiled"] + stats["cached"] > 0
        finally:
            eng.shutdown()

    def test_compile_stats_reports_active_backend(self):
        eng = AlchemistEngine(device="cpu")
        try:
            assert eng.compile_stats()["active_backend"] == \
                eng.default_backend
        finally:
            eng.shutdown()
