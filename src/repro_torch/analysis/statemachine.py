"""Single-source lifecycle state machines + env-gated runtime monitor.

The engine's correctness story is lifecycle discipline: five interacting
state machines (session, handle store, task, upload stream, QoS upload
reservation) spread across ``core/engine.py``, ``core/scheduler.py``,
``core/server.py`` and ``core/qos/admission.py``. The Cray deployment
study (Rothauge et al., 2019) reports that most operational Alchemist
failures were session/teardown races, not compute bugs — the class the
lock tracer catches. This module makes the machines *explicit*, once, in
data, and holds the runtime half of their checking:

* :data:`MACHINES` declares every machine: states, the allowed
  transition edges with the function that may take each one, the lock
  that owns the guarded fields, the functions allowed to mutate them at
  all, and terminal-state obligations ("session gone ⇒ reservations
  released", "refcount 0 ⇒ store reclaimed").
* :class:`StmTrace` asserts the machines on *live* objects when
  ``REPRO_STM_TRACE=1`` (zero overhead off, mirroring ``locktrace``):
  illegal edges, double mints, orphan transitions, and activity scoped
  to an already-forgotten session are recorded and dumped as JSON.

The static checks of the code against the spec and the interleaving
explorer are not part of this package yet.

Like ``locktrace``, this module must not import anything from
``repro_torch.core`` (core imports *us* at module import time).
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading
from typing import Any, Optional

ENV_FLAG = "REPRO_STM_TRACE"
ENV_OUT = "REPRO_STM_TRACE_OUT"


def enabled() -> bool:
    """True when lifecycle tracing is switched on for this process."""
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Edge:
    """One allowed transition, taken only inside function ``site``."""
    src: str
    dst: str
    site: str


@dataclasses.dataclass(frozen=True)
class Obligation:
    """Calls a site must (lexically) make — e.g. teardown must release
    reservations. ``must_call`` entries match any dotted call name by
    suffix (``"admission.forget_session"`` matches
    ``self.admission.forget_session(...)``)."""
    site: str
    must_call: tuple[str, ...]
    reason: str


@dataclasses.dataclass(frozen=True)
class ScopeCheck:
    """Runtime terminal-state obligation across machines: when *this*
    machine's subject reaches a terminal state, no live object of
    ``machine`` scoped to it may still be in one of ``bad_states``
    (except when the transition site is in ``exempt_sites`` — engine
    shutdown tears everything down at once, in bulk)."""
    machine: str
    bad_states: tuple[str, ...]
    reason: str
    exempt_sites: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Machine:
    """One lifecycle state machine, fully declared.

    ``guarded`` names the attributes whose mutation *is* a transition
    (or bookkeeping inseparable from one); the static pass flags any
    mutation of them outside ``sites``. ``lock``/``lockattr`` name the
    owning lock (``locktrace`` registry name / ``self.<attr>``);
    ``caller_locked`` lists sites that run with the lock already held by
    their caller (constructors, documented internal helpers)."""
    name: str
    subject: str
    modules: tuple[str, ...]
    guarded: tuple[str, ...]
    states: tuple[str, ...]
    initial: str
    terminal: tuple[str, ...]
    lock: Optional[str]
    lockattr: Optional[str]
    mint_sites: tuple[str, ...]
    edges: tuple[Edge, ...]
    extra_sites: tuple[str, ...] = ()
    caller_locked: tuple[str, ...] = ()
    obligations: tuple[Obligation, ...] = ()
    scope_checks: tuple[ScopeCheck, ...] = ()

    @property
    def sites(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for s in self.mint_sites:
            seen.setdefault(s)
        for e in self.edges:
            seen.setdefault(e.site)
        for s in self.extra_sites:
            seen.setdefault(s)
        return tuple(seen)

    def legal(self) -> frozenset[tuple[str, str]]:
        return frozenset((e.src, e.dst) for e in self.edges)


MACHINES: tuple[Machine, ...] = (
    Machine(
        name="task",
        subject="scheduler task-table row",
        modules=("core/scheduler.py",),
        guarded=("_tasks", "state"),
        states=("QUEUED", "RUNNING", "DONE", "FAILED", "RELEASED"),
        initial="QUEUED",
        terminal=("RELEASED",),
        lock="scheduler.cv",
        lockattr="_cv",
        mint_sites=("submit",),
        edges=(
            Edge("QUEUED", "RUNNING", "_worker"),
            Edge("QUEUED", "RUNNING", "claim_chain"),
            Edge("RUNNING", "DONE", "_finish"),
            Edge("RUNNING", "FAILED", "_finish"),
            Edge("QUEUED", "FAILED", "_finish"),
            Edge("QUEUED", "FAILED", "shutdown"),
            Edge("RUNNING", "FAILED", "shutdown"),
            Edge("DONE", "RELEASED", "release"),
            Edge("FAILED", "RELEASED", "release"),
            Edge("DONE", "RELEASED", "forget_session"),
            Edge("FAILED", "RELEASED", "forget_session"),
        ),
        extra_sites=("__init__",),
        caller_locked=("__init__",),
        obligations=(
            Obligation("_finish", ("notify_all",),
                       "completion must wake wait()/wait_session() blockers"),
            Obligation("shutdown", ("notify_all",),
                       "failing queued tasks must wake their waiters"),
        ),
    ),
    Machine(
        name="session",
        subject="engine client session",
        modules=("core/engine.py",),
        guarded=("_sessions", "draining"),
        states=("ACTIVE", "DRAINING", "FORGOTTEN"),
        initial="ACTIVE",
        terminal=("FORGOTTEN",),
        lock="engine.state",
        lockattr="_state_lock",
        mint_sites=("__init__", "connect"),
        edges=(
            Edge("ACTIVE", "DRAINING", "disconnect"),
            Edge("DRAINING", "FORGOTTEN", "disconnect"),
            Edge("ACTIVE", "FORGOTTEN", "shutdown"),
            Edge("DRAINING", "FORGOTTEN", "shutdown"),
        ),
        caller_locked=("__init__",),
        obligations=(
            Obligation("disconnect",
                       ("scheduler.wait_session", "scheduler.forget_session",
                        "admission.forget_session", "free_session"),
                       "teardown must drain in-flight tasks, reclaim the "
                       "handle namespace, drop retained task rows, and "
                       "return reserved QoS bytes"),
        ),
        scope_checks=(
            ScopeCheck("task", ("QUEUED", "RUNNING"),
                       "a forgotten session must have no in-flight tasks "
                       "(disconnect drains before it pops)",
                       exempt_sites=("shutdown",)),
            ScopeCheck("upload", ("OPEN",),
                       "a forgotten session must have no half-streamed "
                       "uploads (teardown aborts them first)",
                       exempt_sites=("shutdown",)),
            ScopeCheck("reservation", ("ACTIVE",),
                       "session gone ⇒ reserved in-flight upload bytes "
                       "released (else the quota leaks forever)",
                       exempt_sites=("shutdown",)),
        ),
    ),
    Machine(
        name="store",
        subject="refcounted matrix store",
        modules=("core/engine.py", "core/transfer.py"),
        guarded=("_stores", "_entries", "refs", "host"),
        states=("LIVE", "SPILLED", "RECLAIMED"),
        initial="LIVE",
        terminal=("RECLAIMED",),
        lock="engine.state",
        lockattr="_state_lock",
        mint_sites=("put", "overwrite"),
        edges=(
            Edge("LIVE", "SPILLED", "_enforce_budget"),
            Edge("SPILLED", "LIVE", "get"),
            # in-place overwrite of a spilled store installs the new
            # device array directly — it comes back resident without
            # passing through get()'s reload
            Edge("SPILLED", "LIVE", "overwrite"),
            Edge("LIVE", "RECLAIMED", "_drop_binding"),
            Edge("SPILLED", "RECLAIMED", "_drop_binding"),
        ),
        extra_sites=("__init__", "free", "retain", "_alias_store",
                     "_deliver_cached", "_cache_store_result", "shutdown"),
        caller_locked=("__init__", "_alias_store", "_drop_binding",
                       "_enforce_budget", "_deliver_cached",
                       "_cache_store_result"),
        obligations=(
            Obligation("free", ("_drop_binding",),
                       "refcount 0 ⇒ the binding (and at zero store refs "
                       "the store) is reclaimed"),
            Obligation("_drop_binding", ("_cache_invalidate",),
                       "a reclaimed binding's memoized outputs would "
                       "dangle — the cache entry must go with it"),
        ),
    ),
    Machine(
        name="upload",
        subject="server-side chunked upload stream",
        modules=("core/server.py",),
        guarded=("uploads",),
        states=("OPEN", "COMMITTED", "ABORTED"),
        initial="OPEN",
        terminal=("COMMITTED", "ABORTED"),
        lock=None,          # per-connection: only its reader thread touches it
        lockattr=None,
        mint_sites=("_do_upload_begin",),
        edges=(
            Edge("OPEN", "COMMITTED", "_do_upload_commit"),
            Edge("OPEN", "ABORTED", "_do_upload_commit"),
            Edge("OPEN", "ABORTED", "_teardown"),
            # client-requested disconnect with streams still open: the
            # handshake path aborts them before the engine forgets the
            # session (a stream whose session is gone can never commit)
            Edge("OPEN", "ABORTED", "_abort_session_uploads"),
        ),
        extra_sites=("__init__",),
        caller_locked=("__init__",),
        obligations=(
            Obligation("_do_upload_commit", ("release_upload",),
                       "committed or failed, the stream is no longer in "
                       "flight — its reserved bytes must be returned"),
            Obligation("_teardown", ("release_upload",),
                       "a vanished client's half-streamed uploads must "
                       "release their in-flight quota reservations"),
            Obligation("_abort_session_uploads", ("release_upload",),
                       "an upload aborted at disconnect must return its "
                       "reserved in-flight bytes"),
        ),
    ),
    Machine(
        name="reservation",
        subject="per-session in-flight upload byte reservation",
        modules=("core/qos/admission.py",),
        guarded=("_inflight",),
        states=("IDLE", "ACTIVE", "RELEASED"),
        initial="IDLE",
        terminal=("RELEASED",),
        lock="qos.admission",
        lockattr="_lock",
        mint_sites=("__init__",),
        edges=(
            Edge("IDLE", "ACTIVE", "reserve_upload"),
            Edge("ACTIVE", "ACTIVE", "reserve_upload"),
            Edge("ACTIVE", "IDLE", "release_upload"),
            Edge("IDLE", "IDLE", "release_upload"),
            Edge("ACTIVE", "RELEASED", "forget_session"),
            Edge("IDLE", "RELEASED", "forget_session"),
        ),
        caller_locked=("__init__",),
    ),
)

MACHINES_BY_NAME: dict[str, Machine] = {m.name: m for m in MACHINES}


# ---------------------------------------------------------------------------
# Runtime monitor
# ---------------------------------------------------------------------------

class StmTrace:
    """Process-wide lifecycle monitor. Instrumented objects call
    :meth:`mint` when a subject is created and :meth:`note` at every
    transition; the monitor checks each (src, dst) pair against the
    spec's edge set and records violations instead of raising (the
    traced run must complete so the report is whole — tests and the
    explorer call :meth:`assert_clean` afterwards).

    Keys are ``(domain, id)`` tuples (domain = the owning engine, so
    concurrent engines in one test process never collide); ``scope`` ties
    a subject to its session key for the cross-machine terminal checks
    (dead-scope: nothing may be minted into, or transition non-terminally
    inside, a forgotten session)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()     # internal, deliberately untraced
        self._legal = {m.name: m.legal() for m in MACHINES}
        self._terminal = {m.name: frozenset(m.terminal) for m in MACHINES}
        self._initial = {m.name: m.initial for m in MACHINES}
        self._scope_checks = {m.name: m.scope_checks for m in MACHINES}
        self.reset()

    # the real tracer is "on"; the _Null stand-in is not. Core guards
    # every call site with ``if self._stm.enabled:`` so the off path
    # costs one attribute load.
    enabled = True

    def reset(self) -> None:
        with self._mu:
            self._state: dict[tuple[str, Any], str] = {}
            self._scope_of: dict[tuple[str, Any], Any] = {}
            self._dead_scopes: set[Any] = set()
            self._violations: list[dict] = []
            self._transitions = 0

    # ---- recording ----------------------------------------------------
    def mint(self, machine: str, key: Any, *, site: str,
             scope: Any = None, state: Optional[str] = None) -> None:
        st = state if state is not None else self._initial[machine]
        with self._mu:
            self._transitions += 1
            mkey = (machine, key)
            prior = self._state.get(mkey)
            if prior is not None and prior not in self._terminal[machine]:
                self._record(
                    "remint", machine, key, site,
                    f"minted while a prior subject is still {prior}")
            if scope is not None and scope in self._dead_scopes:
                self._record(
                    "dead-scope", machine, key, site,
                    f"minted into forgotten session scope {scope!r}")
            self._state[mkey] = st
            if scope is not None:
                self._scope_of[mkey] = scope

    def note(self, machine: str, key: Any, dst: str, *,
             site: str) -> None:
        with self._mu:
            self._transitions += 1
            mkey = (machine, key)
            src = self._state.get(mkey)
            if src is None:
                self._record(
                    "orphan", machine, key, site,
                    f"transition to {dst} on a subject never minted")
            elif (src, dst) not in self._legal[machine]:
                self._record(
                    "illegal-edge", machine, key, site,
                    f"{src} -> {dst} is not a declared edge")
            scope = self._scope_of.get(mkey)
            if scope is not None and scope in self._dead_scopes and \
                    dst not in self._terminal[machine]:
                self._record(
                    "dead-scope", machine, key, site,
                    f"non-terminal transition to {dst} inside forgotten "
                    f"session scope {scope!r}")
            self._state[mkey] = dst
            if dst in self._terminal[machine]:
                self._on_terminal(machine, key, site)

    def _on_terminal(self, machine: str, key: Any, site: str) -> None:
        # called with self._mu held
        for sc in self._scope_checks[machine]:
            if site in sc.exempt_sites:
                continue
            bad = set(sc.bad_states)
            for (om, okey), ostate in self._state.items():
                if om != sc.machine or ostate not in bad:
                    continue
                if self._scope_of.get((om, okey)) == key:
                    self._record(
                        "obligation", om, okey, site,
                        f"still {ostate} when its session scope reached "
                        f"a terminal state: {sc.reason}")
        if machine == "session":
            self._dead_scopes.add(key)

    def _record(self, kind: str, machine: str, key: Any, site: str,
                detail: str) -> None:
        self._violations.append({
            "kind": kind, "machine": machine, "key": repr(key),
            "site": site, "detail": detail})

    # ---- reading ------------------------------------------------------
    def state_of(self, machine: str, key: Any) -> Optional[str]:
        with self._mu:
            return self._state.get((machine, key))

    def report(self) -> dict:
        with self._mu:
            live = {}
            for (machine, key), st in self._state.items():
                if st not in self._terminal[machine]:
                    live.setdefault(machine, 0)
                    live[machine] += 1
            return {"enabled": enabled(),
                    "transitions": self._transitions,
                    "live": live,
                    "violations": list(self._violations)}

    def violations(self) -> list[dict]:
        with self._mu:
            return list(self._violations)

    def assert_clean(self) -> None:
        bad = self.violations()
        if bad:
            lines = [f"  [{v['kind']}] {v['machine']}{v['key']} @ "
                     f"{v['site']}: {v['detail']}" for v in bad]
            raise AssertionError(
                "lifecycle state-machine violations:\n" + "\n".join(lines))


class _Null:
    """The off-switch: every instrumented call site checks ``.enabled``
    first, so none of these methods run on hot paths."""
    enabled = False

    def mint(self, *a: Any, **k: Any) -> None:  # pragma: no cover
        pass

    def note(self, *a: Any, **k: Any) -> None:  # pragma: no cover
        pass


TRACE = StmTrace()
_NULL = _Null()


def tracer():
    """What instrumented objects bind at construction: the live monitor
    when ``REPRO_STM_TRACE=1``, a no-op otherwise. Like locktrace's
    factories, the decision is taken once, at construction — flipping
    the env var mid-run affects new objects only."""
    return TRACE if enabled() else _NULL


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    if not enabled():
        return
    out = os.environ.get(ENV_OUT, "")
    rep = TRACE.report()
    text = json.dumps(rep, indent=2, sort_keys=True)
    if out:
        try:
            with open(out, "w") as f:
                f.write(text + "\n")
        except OSError:
            pass
    elif rep["violations"]:
        import sys
        print("=== repro.analysis.statemachine report ===", file=sys.stderr)
        print(text, file=sys.stderr)


atexit.register(_dump_at_exit)
