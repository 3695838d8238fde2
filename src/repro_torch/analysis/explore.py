"""Deterministic interleaving explorer for the lifecycle machines.

``python -m repro_torch.analysis.explore --scenario disconnect_vs_midtask
--device cuda``

The statemachine runtime monitor (``REPRO_STM_TRACE=1``) is a passive
oracle: it only catches a lifecycle race if the suite happens to hit the
losing interleaving. This module *drives* the interleavings instead of
waiting for them: a seeded cooperative scheduler
(:class:`InterleaveController`) parks the scenario's threads at yield
points — every monitor transition plus scenario-injected points inside
the known race windows — and a bounded DFS over the grant order
(:func:`sweep`) enumerates the reachable schedules, a few hundred per
scenario, with the monitor's violation list plus scenario post-condition
checks as the verdict.

Five scenarios cover the stack's real race windows:

* ``fixture_injected`` — a fully cooperative fixture (no engine) with a
  known bug: release racing completion. The sweep *must* find its
  illegal edge, and replaying the found schedule (``--replay``) must
  reproduce the identical violation — the explorer proving it can
  detect and deterministically replay a seeded bug.
* ``submit_vs_release`` — a deferred-consumer submit racing the
  producer's release-on-delivery (the task-table row-retention rule).
* ``claim_chain_vs_hazard`` — chain claiming racing another session's
  interleaved hazard write on the same handle.
* ``disconnect_vs_midtask`` — the submit endpoint racing session
  teardown (the window engine.submit's locked re-validation closes:
  without it, a task is minted into a forgotten session's scope).
* ``throttle_release_vs_commit`` — a QoS upload reservation racing
  disconnect's ``forget_session`` (the window engine.reserve_upload's
  compensating release closes: without it, in-flight bytes leak
  forever).

Only the threads a scenario registers are scheduled; engine worker
threads free-run (their yield points pass through), so real-engine
scenarios are bounded sweeps with a deterministic *choice order*, while
the fixture scenario — all of whose actors are registered — is exactly
replayable.

The two engine scenarios build their engine on an explicit ``device``
(``"cuda"``, the default, raises when CUDA is absent; the tests pass
``"cpu"``); the others touch no device, and the device is checked all
the same.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import zlib
from typing import Any, Callable, Optional

from repro_torch.analysis import statemachine


class InterleaveController:
    """Seeded cooperative scheduler over explicitly registered threads.

    Registered threads block at every :meth:`point` until granted; the
    coordinator (:meth:`drive`) waits for the system to quiesce — every
    registered thread parked, done, or stalled behind a parked peer's
    lock — then grants exactly one parked thread, chosen by the forced
    ``schedule`` prefix (DFS replay) and falling back to index 0. The
    parked set is ordered by a seeded hash (``zlib.crc32``, *not*
    ``hash()`` — PYTHONHASHSEED must not change schedules), so choice
    indices mean the same thread across runs of the same seed.

    Unregistered threads (engine workers) pass straight through
    ``point`` — they are environment, not actors.
    """

    SETTLE_S = 0.02      # grace for running threads to reach a point
    WEDGE_S = 5.0        # no progress at all -> open every gate

    def __init__(self, seed: int = 0,
                 schedule: Optional[list[int]] = None):
        self.seed = int(seed)
        self.forced = list(schedule or [])
        self.choices: list[tuple[int, int]] = []   # (picked, branching)
        self.trail: list[str] = []                 # names, for humans
        self.errors: dict[str, str] = {}           # thread -> exception
        self.wedged = False
        self._cv = threading.Condition()
        self._status: dict[str, str] = {}  # new|running|parked|done
        self._names: dict[int, str] = {}   # thread ident -> name
        self._grant: set[str] = set()
        self._gen = 0
        self._free = False
        self._threads: list[threading.Thread] = []

    # ---- actor side ----------------------------------------------------
    def spawn(self, name: str, fn: Callable[[], None]) -> None:
        """Register a scenario thread; started by :meth:`drive`."""
        def run() -> None:
            with self._cv:
                self._names[threading.get_ident()] = name
                self._status[name] = "running"
                self._gen += 1
                self._cv.notify_all()
            try:
                fn()
            except Exception as e:  # surfaced as a failed check
                self.errors[name] = f"{type(e).__name__}: {e}"
            finally:
                with self._cv:
                    self._status[name] = "done"
                    self._names.pop(threading.get_ident(), None)
                    self._gen += 1
                    self._cv.notify_all()
        with self._cv:
            self._status[name] = "new"
        self._threads.append(
            threading.Thread(target=run, daemon=True, name=name))

    def point(self, tag: str = "") -> None:
        """A schedulable yield point. Registered threads park here until
        the coordinator grants them; everyone else passes through."""
        ident = threading.get_ident()
        with self._cv:
            name = self._names.get(ident)
            if name is None or self._free:
                return
            self._status[name] = "parked"
            self._gen += 1
            self._cv.notify_all()
            while name not in self._grant and not self._free:
                self._cv.wait(1.0)
            self._grant.discard(name)
            self._status[name] = "running"
            self._gen += 1
            self._cv.notify_all()

    # ---- coordinator side ----------------------------------------------
    def drive(self) -> None:
        """Start the registered threads and schedule them to completion
        (or wedge, which opens every gate and lets the rest free-run)."""
        for th in self._threads:
            th.start()
        last_gen = -1
        deadline = time.monotonic() + self.WEDGE_S
        with self._cv:
            while True:
                if self._gen != last_gen:
                    last_gen = self._gen
                    deadline = time.monotonic() + self.WEDGE_S
                if all(s == "done" for s in self._status.values()):
                    break
                parked = sorted(n for n, s in self._status.items()
                                if s == "parked")
                busy = [n for n, s in self._status.items()
                        if s in ("new", "running")]
                if parked and not busy:
                    self._pick(parked)
                    continue
                if parked and busy:
                    # busy threads get a settle window to reach a point;
                    # if nothing moves they are blocked behind a parked
                    # peer's lock — scheduling a parked thread is then
                    # the only way to make progress
                    gen = self._gen
                    self._cv.wait(self.SETTLE_S)
                    if self._gen == gen:
                        self._pick(parked)
                    continue
                if time.monotonic() > deadline:
                    self.wedged = True
                    self._free = True
                    self._grant.update(self._status)
                    self._cv.notify_all()
                    break
                self._cv.wait(0.05)
        for th in self._threads:
            th.join(timeout=10.0)

    def _pick(self, parked: list[str]) -> None:
        # deterministic parked order: seeded digest, then name
        step = len(self.choices)
        order = sorted(parked, key=lambda n: (zlib.crc32(
            f"{n}|{self.seed}|{step}".encode()), n))
        want = self.forced[step] if step < len(self.forced) else 0
        idx = min(max(int(want), 0), len(order) - 1)
        self.choices.append((idx, len(order)))
        name = order[idx]
        self.trail.append(name)
        self._grant.add(name)
        self._cv.notify_all()
        # wait for the grant to be consumed before choosing again
        while name in self._grant and not self._free:
            self._cv.wait(1.0)


class _HookedTrace(statemachine.StmTrace):
    """The runtime monitor with every transition doubling as a yield
    point: the interleave decision lands immediately *before* each
    lifecycle transition commits."""

    def __init__(self, controller: InterleaveController):
        super().__init__()
        self._controller = controller

    def mint(self, machine: str, key: Any, *, site: str,
             scope: Any = None, state: Optional[str] = None) -> None:
        self._controller.point(f"mint:{machine}:{site}")
        super().mint(machine, key, site=site, scope=scope, state=state)

    def note(self, machine: str, key: Any, dst: str, *,
             site: str) -> None:
        self._controller.point(f"note:{machine}:{site}")
        super().note(machine, key, dst, site=site)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def _scn_fixture_injected(ctrl: InterleaveController,
                          device: Any) -> list[str]:
    """A seeded bug in a cooperative fixture: release() racing the
    worker's RUNNING/DONE transitions on one task row. Orders where the
    release lands before _finish take an undeclared edge — the sweep
    must find them, and a replay must reproduce them exactly."""
    trace = statemachine.TRACE          # the hooked instance
    trace.mint("task", ("fx", 1), site="submit", scope=("fx", 0))

    def finisher() -> None:
        ctrl.point("F:pre-run")
        trace.note("task", ("fx", 1), "RUNNING", site="_worker")
        ctrl.point("F:pre-finish")
        trace.note("task", ("fx", 1), "DONE", site="_finish")

    def releaser() -> None:
        ctrl.point("R:pre-release")
        # the bug: no terminal-state check before dropping the row
        trace.note("task", ("fx", 1), "RELEASED", site="release")

    ctrl.spawn("finisher", finisher)
    ctrl.spawn("releaser", releaser)
    ctrl.drive()
    return []


def _scn_submit_vs_release(ctrl: InterleaveController,
                           device: Any) -> list[str]:
    """Deferred-consumer submit racing the producer row's
    release-on-delivery: the dependency edge recorded at submit must
    keep the producer row alive until the consumer is terminal."""
    from repro_torch.core import scheduler as scheduling
    sched = scheduling.TaskScheduler(num_workers=2)
    out: dict[str, Any] = {}
    t1 = sched.submit(lambda t: 1, session=7, label="producer")

    def waiter() -> None:
        sched.wait(t1.id, timeout=10.0)
        ctrl.point("A:pre-release")
        sched.release(t1.id)

    def chainer() -> None:
        ctrl.point("B:pre-submit")
        t2 = sched.submit(lambda t: 2, session=7, data_deps=[t1.id],
                          label="consumer")
        out["t2"] = t2
        sched.wait(t2.id, timeout=10.0)
        sched.release(t2.id)

    ctrl.spawn("waiter", waiter)
    ctrl.spawn("chainer", chainer)
    ctrl.drive()
    checks = [f"{n}: {e}" for n, e in ctrl.errors.items()]
    t2 = out.get("t2")
    if t2 is None or t2.state != scheduling.DONE:
        checks.append("consumer task did not reach DONE")
    sched.shutdown()
    return checks


def _scn_claim_chain_vs_hazard(ctrl: InterleaveController,
                               device: Any) -> list[str]:
    """Chain claiming racing another session's interleaved write on the
    chain's handle: every claimed transition must be a declared edge and
    the hazard task must still complete."""
    from repro_torch.core import scheduler as scheduling
    sched = scheduling.TaskScheduler(num_workers=2)
    gate = threading.Event()
    H = 42
    sched.pause()
    lead = sched.submit(lambda t: gate.wait(10.0), session=1,
                        writes=[H], label="lead")
    dep = sched.submit(lambda t: "dep", session=1, reads=[H],
                       label="dep")
    sched.resume()
    for _ in range(2000):               # lead RUNNING before the race
        if sched.task(lead.id).state == scheduling.RUNNING:
            break
        time.sleep(0.002)
    out: dict[str, Any] = {}

    def claimer() -> None:
        ctrl.point("A:pre-claim")
        chain = sched.claim_chain(lead.id, lambda t: True)
        ctrl.point("A:claimed")
        for t in chain:
            sched.finish_claimed(t.id, result="claimed")
        out["chain"] = [t.id for t in chain]
        gate.set()

    def hazard() -> None:
        ctrl.point("B:pre-submit")
        w = sched.submit(lambda t: "w", session=2, writes=[H],
                         label="hazard-write")
        out["w"] = w
        sched.wait(w.id, timeout=10.0)

    ctrl.spawn("claimer", claimer)
    ctrl.spawn("hazard", hazard)
    ctrl.drive()
    gate.set()
    checks = [f"{n}: {e}" for n, e in ctrl.errors.items()]
    try:
        sched.wait(lead.id, timeout=10.0)
        sched.wait(dep.id, timeout=10.0)
        if out.get("w") is not None and \
                sched.task(out["w"].id).state != scheduling.DONE:
            checks.append("hazard write did not reach DONE")
    except Exception as e:
        checks.append(f"drain: {type(e).__name__}: {e}")
    sched.shutdown()
    return checks


def _mk_engine(device: Any, **kw: Any):
    from repro_torch.core.engine import AlchemistEngine
    kw.setdefault("scheduler_workers", 2)
    kw.setdefault("cache_entries", 0)
    return AlchemistEngine(device=device, **kw)


def _scn_disconnect_vs_midtask(ctrl: InterleaveController,
                               device: Any) -> list[str]:
    """The submit endpoint racing session teardown. The injected yield
    sits exactly in the historical window — after the unlocked session
    check, before the task mint — so the sweep covers the schedule where
    disconnect drains and pops in between. The locked re-validation in
    engine.submit must reject that schedule; without it the monitor sees
    a task minted into a forgotten session's scope (dead-scope)."""
    from repro_torch.core import protocol as P
    from repro_torch.core.engine import ENGINE_LIBRARY
    eng = _mk_engine(device, qos=True)
    sess = eng.connect("racer")
    real_hazards = eng._hazards

    def hooked_hazards(cmd):            # the race window, made schedulable
        res = real_hazards(cmd)
        ctrl.point("A:post-check-pre-mint")
        return res
    eng._hazards = hooked_hazards
    out: dict[str, Any] = {}

    def submitter() -> None:
        ctrl.point("A:pre-submit")
        cmd = P.Command(library=ENGINE_LIBRARY, routine="qos_stats",
                        session=sess.id, args={})
        r = P.decode_result(eng.submit(P.encode_command(cmd)))
        out["error"] = r.error
        if r.task:
            try:
                eng.wait_task(r.task, session=sess.id)
            except Exception:
                pass

    def killer() -> None:
        ctrl.point("B:pre-disconnect")
        eng.disconnect(sess.id)

    ctrl.spawn("submitter", submitter)
    ctrl.spawn("killer", killer)
    ctrl.drive()
    checks = [f"{n}: {e}" for n, e in ctrl.errors.items()]
    if sess.id in eng._sessions:
        checks.append("session survived disconnect")
    if eng.scheduler.session_depth(sess.id) != 0:
        checks.append("forgotten session still has in-flight tasks")
    if eng.admission.inflight_bytes(sess.id) != 0:
        checks.append("forgotten session leaked in-flight bytes")
    eng.shutdown()
    return checks


def _scn_throttle_release_vs_commit(ctrl: InterleaveController,
                                    device: Any) -> list[str]:
    """A QoS upload reservation racing disconnect's forget_session. The
    injected yield sits between the admission grant and engine-side
    liveness re-check; the compensating release must leave zero held
    bytes on every schedule — without it, the schedule where disconnect
    lands inside the window re-creates the forgotten row and leaks it."""
    eng = _mk_engine(device, qos=True, scheduler_workers=1,
                     qos_quotas={"max_inflight_bytes": 1 << 20})
    sess = eng.connect("uploader")
    real_reserve = eng.admission.reserve_upload

    def hooked_reserve(session, nbytes, weight=1.0):
        res = real_reserve(session, nbytes, weight=weight)
        ctrl.point("A:admission-reserved")   # the race window
        return res
    eng.admission.reserve_upload = hooked_reserve

    def uploader() -> None:
        ctrl.point("A:pre-reserve")
        denial = eng.reserve_upload(sess.id, 4096)
        ctrl.point("A:reserved")
        if denial is None:
            eng.release_upload(sess.id, 4096)    # the commit path

    def killer() -> None:
        ctrl.point("B:pre-disconnect")
        eng.disconnect(sess.id)

    ctrl.spawn("uploader", uploader)
    ctrl.spawn("killer", killer)
    ctrl.drive()
    checks = [f"{n}: {e}" for n, e in ctrl.errors.items()]
    held = eng.admission.inflight_bytes(sess.id)
    if held != 0:
        checks.append(f"leaked {held} reserved in-flight bytes")
    if sess.id in eng._sessions:
        checks.append("session survived disconnect")
    eng.shutdown()
    return checks


SCENARIOS: dict[str, dict[str, Any]] = {
    "fixture_injected": {
        "fn": _scn_fixture_injected, "expect": "violation",
        "doc": "cooperative fixture with a seeded release-vs-finish bug "
               "(the sweep must find it; --replay must reproduce it)"},
    "submit_vs_release": {
        "fn": _scn_submit_vs_release, "expect": "clean",
        "doc": "deferred-consumer submit vs producer release-on-delivery"},
    "claim_chain_vs_hazard": {
        "fn": _scn_claim_chain_vs_hazard, "expect": "clean",
        "doc": "chain claiming vs another session's interleaved hazard "
               "write"},
    "disconnect_vs_midtask": {
        "fn": _scn_disconnect_vs_midtask, "expect": "clean",
        "doc": "submit endpoint vs session teardown (the locked "
               "re-validation window)"},
    "throttle_release_vs_commit": {
        "fn": _scn_throttle_release_vs_commit, "expect": "clean",
        "doc": "QoS upload reservation vs disconnect forget_session "
               "(the compensating-release window)"},
}


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def run_schedule(name: str, seed: int = 0,
                 schedule: Optional[list[int]] = None,
                 device: Any = "cuda") -> dict:
    """Run one scenario under one forced schedule prefix, its engine (if
    any) on ``device``. Installs a hooked monitor for the duration;
    returns the schedule's record."""
    from repro_torch.common.device import explicit_device
    dev = explicit_device(device, "explore")
    scn = SCENARIOS[name]
    ctrl = InterleaveController(seed=seed, schedule=schedule)
    trace = _HookedTrace(ctrl)
    old_trace = statemachine.TRACE
    old_env = os.environ.get(statemachine.ENV_FLAG)
    statemachine.TRACE = trace
    os.environ[statemachine.ENV_FLAG] = "1"
    try:
        failed_checks = scn["fn"](ctrl, dev)
    finally:
        statemachine.TRACE = old_trace
        if old_env is None:
            os.environ.pop(statemachine.ENV_FLAG, None)
        else:
            os.environ[statemachine.ENV_FLAG] = old_env
    return {"scenario": name, "seed": seed,
            "schedule": list(schedule or []),
            "choices": [list(c) for c in ctrl.choices],
            "trail": ctrl.trail, "wedged": ctrl.wedged,
            "violations": trace.violations(),
            "failed_checks": failed_checks}


def next_schedule(choices: list) -> Optional[list[int]]:
    """DFS successor of a recorded choice sequence: bump the deepest
    position with untried alternatives, truncate below it. None when the
    tree is exhausted."""
    for i in range(len(choices) - 1, -1, -1):
        idx, branching = choices[i]
        if idx + 1 < branching:
            return [c[0] for c in choices[:i]] + [idx + 1]
    return None


def sweep(name: str, seed: int = 0, max_schedules: int = 64,
          device: Any = "cuda") -> dict:
    """Bounded DFS over a scenario's schedules, engines on ``device``.
    Returns the aggregate report the CLI emits as JSON."""
    results: list[dict] = []
    schedule: Optional[list[int]] = []
    while schedule is not None and len(results) < max_schedules:
        res = run_schedule(name, seed=seed, schedule=schedule,
                           device=device)
        results.append(res)
        schedule = next_schedule(res["choices"])
    violating = [r for r in results if r["violations"]]
    failing = [r for r in results if r["failed_checks"]]
    expect = SCENARIOS[name]["expect"]
    ok = not failing and not all(r["wedged"] for r in results) and (
        bool(violating) if expect == "violation" else not violating)
    return {"scenario": name, "seed": seed, "expect": expect,
            "schedules_run": len(results),
            "exhausted": schedule is None,
            "wedged": sum(1 for r in results if r["wedged"]),
            "violating_schedules": [
                [c[0] for c in r["choices"]] for r in violating],
            "failed_checks": sorted(
                {c for r in failing for c in r["failed_checks"]}),
            "ok": ok,
            "results": results}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explore",
        description="Seeded deterministic interleaving explorer with the "
                    "lifecycle state-machine monitor as oracle")
    ap.add_argument("--scenario", required=True,
                    choices=sorted(SCENARIOS),
                    help="race window to sweep")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the parked-thread choice order")
    ap.add_argument("--schedules", type=int, default=64,
                    help="DFS budget (schedules per sweep)")
    ap.add_argument("--replay", default=None, metavar="I,J,K",
                    help="run exactly one schedule: comma-separated "
                    "choice indices as printed in violating_schedules")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report to PATH")
    ap.add_argument("--device", default="cuda",
                    help="device of the scenarios' engines: cuda (the "
                    "default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    if args.replay is not None:
        forced = [int(x) for x in args.replay.split(",") if x.strip()]
        res = run_schedule(args.scenario, seed=args.seed, schedule=forced,
                           device=args.device)
        report: dict = {"scenario": args.scenario, "seed": args.seed,
                        "replay": forced, "result": res}
        found = bool(res["violations"])
        print(f"replay {forced} -> {len(res['violations'])} violation(s), "
              f"{len(res['failed_checks'])} failed check(s)"
              + (" [WEDGED]" if res["wedged"] else ""))
        for v in res["violations"]:
            print(f"  [{v['kind']}] {v['machine']}{v['key']} @ "
                  f"{v['site']}: {v['detail']}")
        ok = not res["failed_checks"] and (
            found if SCENARIOS[args.scenario]["expect"] == "violation"
            else not found)
    else:
        report = sweep(args.scenario, seed=args.seed,
                       max_schedules=args.schedules, device=args.device)
        ok = report["ok"]
        print(f"{args.scenario}: {report['schedules_run']} schedule(s) "
              f"(seed {args.seed}, "
              f"{'exhausted' if report['exhausted'] else 'budget-capped'}"
              f", {report['wedged']} wedged) -> "
              f"{len(report['violating_schedules'])} violating, "
              f"{len(report['failed_checks'])} failed check(s): "
              + ("OK" if ok else "FAIL"))
        for s in report["violating_schedules"][:8]:
            print(f"  violating schedule: "
                  f"--replay {','.join(map(str, s))}")
        for c in report["failed_checks"]:
            print(f"  failed check: {c}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
