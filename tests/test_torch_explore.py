"""The port's deterministic interleaving explorer
(``repro_torch.analysis.explore``), end to end: every test of
``tests/test_explore.py``, pointed at the port with engines on the CPU,
plus the cross-package check that both explorers find and replay the
seeded fixture bug.

Four claims, each load-bearing:

* **it finds bugs** — the sweep over ``fixture_injected`` (a seeded
  release-vs-finish race) discovers the violating schedules;
* **it replays them** — re-running a discovered schedule reproduces the
  identical violations, twice, byte for byte (the determinism the
  ``--replay`` workflow depends on);
* **the real windows are closed** — bounded sweeps over the scheduler,
  submit-vs-disconnect, and reservation-vs-disconnect scenarios complete
  with zero monitor violations and zero failed post-conditions;
* **the oracle has teeth** — reverting ``engine.reserve_upload`` to its
  pre-fix shape (grant without the liveness re-check) makes the same
  sweep fail with the illegal RELEASED→ACTIVE edge, reproducibly.

Plus direct, schedule-free regressions for the two races the explorer
found, pinned at the exact historical window via the same hooks the
scenarios use.
"""
import functools

import numpy as np
import pytest
import torch

from repro.analysis import explore as ref_explore
from repro_torch.analysis import explore, statemachine
from repro_torch.analysis.explore import next_schedule

CPU = "cpu"
run_schedule = functools.partial(explore.run_schedule, device=CPU)
sweep = functools.partial(explore.sweep, device=CPU)


# =====================================================================
# DFS mechanics
# =====================================================================
def test_next_schedule_bumps_deepest_untried_branch():
    assert next_schedule([(0, 2), (0, 1), (0, 3)]) == [0, 0, 1]
    assert next_schedule([(0, 2), (2, 3)]) == [0] * 0 + [1]  # deepest done
    assert next_schedule([(1, 2), (2, 3)]) is None           # exhausted
    assert next_schedule([(0, 1)]) is None                   # no branching
    assert next_schedule([]) is None


def test_controller_choice_order_is_seed_stable():
    """Same seed => same parked-thread ordering; the recorded choices of
    two identical runs must match exactly."""
    a = run_schedule("fixture_injected", seed=3, schedule=[])
    b = run_schedule("fixture_injected", seed=3, schedule=[])
    assert a["choices"] == b["choices"] and a["trail"] == b["trail"]


# =====================================================================
# the explorer's own teeth: the seeded fixture bug
# =====================================================================
def test_sweep_finds_the_injected_fixture_bug():
    rep = sweep("fixture_injected", seed=0, max_schedules=32)
    assert rep["exhausted"] and rep["wedged"] == 0
    assert rep["violating_schedules"], "the seeded bug went undetected"
    assert rep["ok"]                      # expect == "violation"
    kinds = {v["kind"] for r in rep["results"] for v in r["violations"]}
    assert "illegal-edge" in kinds


def test_replay_reproduces_identical_violations():
    rep = sweep("fixture_injected", seed=0, max_schedules=32)
    schedule = rep["violating_schedules"][0]
    runs = [run_schedule("fixture_injected", seed=0, schedule=schedule)
            for _ in range(2)]
    assert runs[0]["violations"], "replayed schedule lost the violation"
    assert runs[0]["violations"] == runs[1]["violations"]
    assert runs[0]["trail"] == runs[1]["trail"]
    # and a different seed renumbers choices but the bug is still found
    rep2 = sweep("fixture_injected", seed=17, max_schedules=32)
    assert rep2["violating_schedules"] and rep2["ok"]


def test_cli_sweep_and_replay_roundtrip(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert explore.main(["--scenario", "fixture_injected",
                         "--schedules", "32", "--device", CPU,
                         "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "violating" in text and out.exists()
    # replay the first printed schedule and expect the violation again
    line = next(l for l in text.splitlines() if "--replay" in l)
    sched = line.split("--replay", 1)[1].strip()
    assert explore.main(["--scenario", "fixture_injected",
                         "--replay", sched, "--device", CPU]) == 0
    assert "illegal-edge" in capsys.readouterr().out


# =====================================================================
# the real race windows sweep clean on the fixed engine
# =====================================================================
@pytest.mark.parametrize("scenario,budget", [
    ("submit_vs_release", 8),
    ("claim_chain_vs_hazard", 12),
    ("disconnect_vs_midtask", 20),
    ("throttle_release_vs_commit", 30),
])
def test_real_window_sweeps_are_clean(scenario, budget):
    rep = sweep(scenario, seed=0, max_schedules=budget)
    assert rep["ok"], (rep["violating_schedules"], rep["failed_checks"])
    assert rep["violating_schedules"] == []
    assert rep["failed_checks"] == []
    assert rep["wedged"] < rep["schedules_run"]   # not all wedged


# =====================================================================
# oracle teeth on a real engine: revert the fix, the sweep must fail
# =====================================================================
def test_sweep_catches_prefix_reservation_race(monkeypatch):
    """``engine.reserve_upload`` without the locked liveness re-check
    (the pre-fix shape: grant, note, return) lets a disconnect landing
    inside the admission window revive the forgotten session's
    reservation row. The throttle sweep must catch it — as the illegal
    RELEASED→ACTIVE edge — and the failing schedule must replay."""
    from repro_torch.core.engine import AlchemistEngine

    def naive_reserve(self, session, nbytes):
        if self.admission is None:
            return None
        denial = self.admission.reserve_upload(
            session, nbytes, weight=self._session_weight(session))
        if denial is None and self._stm.enabled:
            self._stm.note("reservation", (self._stm_dom, session),
                           "ACTIVE", site="reserve_upload")
        return denial

    monkeypatch.setattr(AlchemistEngine, "reserve_upload", naive_reserve)
    rep = sweep("throttle_release_vs_commit", seed=0, max_schedules=30)
    assert not rep["ok"], "sweep failed to catch the reverted fix"
    assert rep["violating_schedules"]
    kinds = {v["kind"] for r in rep["results"] for v in r["violations"]}
    assert "illegal-edge" in kinds
    # deterministic replay of the discovered bug
    res = run_schedule("throttle_release_vs_commit", seed=0,
                       schedule=rep["violating_schedules"][0])
    assert any(v["kind"] == "illegal-edge" and
               "RELEASED -> ACTIVE" in v["detail"]
               for v in res["violations"]), res["violations"]


# =====================================================================
# direct regressions for the two races the explorer found
# =====================================================================
def _engine(**kw):
    from repro_torch.core.engine import AlchemistEngine
    kw.setdefault("scheduler_workers", 1)
    kw.setdefault("cache_entries", 0)
    return AlchemistEngine(device=CPU, **kw)


def test_submit_rejects_disconnect_inside_the_window(monkeypatch):
    """Race fix 1, pinned: disconnect completing between submit's
    unlocked session check and the task mint must yield a clean
    UnknownSession error on the wire — no task minted into the freed
    namespace."""
    from repro_torch.core import protocol as P
    from repro_torch.core.engine import ENGINE_LIBRARY
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    eng = _engine(qos=True)
    try:
        sess = eng.connect("victim")
        real_hazards = eng._hazards

        def hazards_then_disconnect(cmd):
            res = real_hazards(cmd)
            eng.disconnect(sess.id)     # lands exactly in the window
            return res
        eng._hazards = hazards_then_disconnect

        cmd = P.Command(library=ENGINE_LIBRARY, routine="qos_stats",
                        session=sess.id, args={})
        r = P.decode_result(eng.submit(P.encode_command(cmd)))
        assert r.error and "UnknownSession" in r.error
        assert not r.task
        assert sess.id not in eng._sessions
        assert eng.scheduler.session_depth(sess.id) == 0
    finally:
        eng.shutdown()
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()


def test_reserve_upload_compensates_when_session_vanishes(monkeypatch):
    """Race fix 2, pinned: a disconnect landing between the admission
    grant and the engine's liveness re-check must turn the grant into a
    denial and leave zero in-flight bytes (the compensating release)."""
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    eng = _engine(qos=True, qos_quotas={"max_inflight_bytes": 1 << 20})
    try:
        sess = eng.connect("vanisher")
        real_reserve = eng.admission.reserve_upload

        def reserve_then_disconnect(session, nbytes, weight=1.0):
            res = real_reserve(session, nbytes, weight=weight)
            eng.disconnect(sess.id)     # lands exactly in the window
            return res
        eng.admission.reserve_upload = reserve_then_disconnect

        denial = eng.reserve_upload(sess.id, 4096)
        assert denial is not None and "disconnecting" in denial[0]
        assert eng.admission.inflight_bytes(sess.id) == 0
        assert sess.id not in eng._sessions
    finally:
        eng.shutdown()
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()


def test_server_aborts_open_uploads_on_client_disconnect(monkeypatch):
    """Hardening pinned at the server layer: a handshake DISCONNECT with
    a chunked upload still open aborts the stream and returns its
    reserved bytes before the engine forgets the session — the monitor
    sees OPEN → ABORTED, never an OPEN stream outliving its session."""
    import msgpack
    from repro_torch.core import protocol, wire
    from repro_torch.core.server import AlchemistServer
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    eng = _engine(qos=True, qos_quotas={"max_inflight_bytes": 1 << 20})
    srv = AlchemistServer(engine=eng).start()
    try:
        bridge = wire.SocketBridge(srv.address)
        reply = protocol.decode_result(bridge.handshake(
            protocol.encode_handshake(protocol.Handshake(
                action=protocol.CONNECT, client="aborter"))))
        sid = reply.values["session"]
        begin = msgpack.packb({"shape": [64, 8], "dtype": "float32",
                               "session": sid, "name": "half-open",
                               "num_chunks": 4, "single": False})
        with bridge._lock:
            bridge._send("upload", wire.FRAME_UPLOAD_BEGIN, begin)
            _, raw = bridge._recv("upload")
        uid = protocol.decode_result(raw).values["upload"]
        chunk = np.ones((16, 8), np.float32)
        bridge._send("upload", wire.FRAME_UPLOAD_CHUNK, msgpack.packb(
            {"upload": uid, "seq": 0, "array": wire.pack_ndarray(chunk)}))
        assert eng.admission.inflight_bytes(sid) > 0
        # clean client-requested DISCONNECT while the stream is OPEN
        bridge.handshake(protocol.encode_handshake(protocol.Handshake(
            action=protocol.DISCONNECT, session=sid)))
        assert eng.admission.inflight_bytes(sid) == 0
        assert sid not in eng._sessions
        bridge.close()
    finally:
        srv.stop()
        eng.shutdown()
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()


# =====================================================================
# both explorers, the port's and the JAX package's, on the seeded bug
# =====================================================================
def test_both_explorers_find_and_replay_the_injected_bug():
    """The same sweep of ``fixture_injected`` in each package finds the
    illegal edge, at the same schedules, and each package's replay of a
    violating schedule reproduces it."""
    port = sweep("fixture_injected", seed=0, max_schedules=32)
    ref = ref_explore.sweep("fixture_injected", seed=0, max_schedules=32)
    for rep in (port, ref):
        assert rep["ok"] and rep["exhausted"] and rep["wedged"] == 0
        assert {v["kind"] for r in rep["results"]
                for v in r["violations"]} == {"illegal-edge"}
    assert port["violating_schedules"] == ref["violating_schedules"]
    assert port["schedules_run"] == ref["schedules_run"]
    schedule = port["violating_schedules"][0]
    replays = (run_schedule("fixture_injected", seed=0, schedule=schedule),
               ref_explore.run_schedule("fixture_injected", seed=0,
                                        schedule=schedule))
    for res in replays:
        assert any(v["kind"] == "illegal-edge" for v in res["violations"])
    assert [v["detail"] for v in replays[0]["violations"]] == \
        [v["detail"] for v in replays[1]["violations"]]
    assert replays[0]["trail"] == replays[1]["trail"]


def test_explorer_device_is_explicit(monkeypatch):
    """``--device`` defaults to cuda, which raises where CUDA is absent:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.main(["--scenario", "fixture_injected", "--schedules", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.run_schedule("disconnect_vs_midtask", schedule=[])
