"""The dynamic lock-order race detector.

Every lock in ``repro.core`` is constructed through the factories here
(:func:`make_lock` / :func:`make_rlock` / :func:`make_condition`) with a
stable dotted name — the static rule ``LCK001`` (``rules_source``)
enforces that no raw ``threading`` lock is constructed in core code, so
the tracker's view of the process is complete by construction.

With ``REPRO_LOCK_TRACE`` unset the factories return the plain
``threading`` primitive: zero wrappers, zero overhead, byte-identical
behavior to the pre-instrumentation code. With it set (``1``), every
acquisition is recorded into one process-wide :class:`LockTrace`:

* the **lock-order graph** — a directed edge ``A -> B`` whenever a
  thread acquires ``B`` while holding ``A``, with the first call site
  kept as the witness. A cycle in this graph is a potential deadlock
  (two threads can interleave the cyclic orders and wedge).
* **rank inversions** — each named lock carries a rank from
  :data:`LOCK_RANKS`, the documented total order (callback delivery ->
  transport -> engine -> scheduler -> backend -> costmodel; see
  docs/architecture.md). Acquiring a lower-ranked lock while holding a
  higher-ranked one is flagged even before a full cycle materializes —
  the rank table is the invariant, the cycle is the crash.
* **waits-under-lock** — a ``Condition.wait`` entered while the thread
  holds *other* traced locks: the sleeper keeps those locks while
  blocked indefinitely, the classic lock-held-across-blocking-call.
* **long holds** — wall-clock hold times above
  :data:`LONG_HOLD_S`, ranked; condition variables are exempt (waiting
  is their job). Long holds are reported, not gated: holding
  ``wire.bridge`` across a socket round trip is the bridge's documented
  request-response contract, but it should be visible, not folklore.

``REPRO_LOCK_TRACE_OUT=<path>`` additionally dumps the JSON report at
interpreter exit, which is how CI feeds ``python -m repro.analysis
--check-lock-report`` after running the fault/scheduler suites under
the tracker.

This module imports only the standard library: ``repro.core`` depends
on it, never the reverse.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional

ENV_FLAG = "REPRO_LOCK_TRACE"
ENV_OUT = "REPRO_LOCK_TRACE_OUT"

#: holds longer than this (outside condition variables) make the ranked
#: long-hold report
LONG_HOLD_S = 0.050

#: The documented lock-ordering rank (lower = acquired first / outer).
#: A thread holding rank r may only acquire locks of rank > r; ranks
#: are unique (LCK002), so the table IS the total order, and the table
#: in docs/architecture.md is generated from (and checked against) it.
#: Unknown names (test fixtures) are exempt from rank checks but still
#: build graph edges.
LOCK_RANKS: dict[str, int] = {
    # completion-callback delivery serializes ahead of everything the
    # engine's on_finish hook re-enters (state lock, cost logs)
    "scheduler.delivery": 5,
    # transport layer: each lock is a leaf of its own thread and is
    # never taken while an engine-layer lock is held (the relative
    # order among the three is therefore free; unique ranks keep the
    # documented total order unambiguous)
    "server.conns": 7,
    "server.send": 8,
    "wire.bridge": 9,
    # the engine state lock may call into the scheduler (hazard probes
    # under _cache_fast_path, session-revalidated task minting) —
    # never the reverse
    "engine.state": 10,
    # QoS admission sits between the engine and the scheduler: checks
    # run from submit/upload paths and may probe scheduler queue depth
    "qos.admission": 12,
    "scheduler.cv": 20,
    # backend program caches sit below the scheduler (compiled under a
    # worker, outside engine/scheduler locks)
    "backend.programs": 30,
    "compilecache.index": 35,
    # cost accounting is always a leaf; the logs never nest with each
    # other, so their relative order is free
    "costmodel.transfer": 40,
    "costmodel.wire": 41,
    "costmodel.task": 42,
    "costmodel.compile": 43,
    "costmodel.cache": 44,
    "costmodel.qos": 45,
}


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0", "false", "off")


def _call_site() -> str:
    """file:line of the nearest frame outside this module (best effort,
    tracing mode only — never on the zero-overhead path)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename.replace(os.sep, "/")
    idx = path.rfind("/repro_torch/")
    if idx < 0:
        idx = path.rfind("/tests/")
    return f"{path[idx + 1:] if idx >= 0 else path}:{f.f_lineno}"


class LockTrace:
    """The process-wide acquisition record (see module docstring)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.reset()

    # ---- bookkeeping --------------------------------------------------
    def reset(self) -> None:
        with self._mu:
            self.names: set[str] = set()
            self.cv_names: set[str] = set()
            # (held, acquired) -> {"count", "site"}
            self.edges: dict[tuple[str, str], dict] = {}
            self.inversions: dict[tuple[str, str], dict] = {}
            self.waits: dict[tuple[str, str], dict] = {}
            # name -> {"count", "total_s", "max_s", "site"}
            self.holds: dict[str, dict] = {}

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @staticmethod
    def _bump(table: dict, key, site: str) -> None:
        row = table.get(key)
        if row is None:
            table[key] = {"count": 1, "site": site}
        else:
            row["count"] += 1

    # ---- event hooks (called by the traced primitives) ----------------
    def note_acquired(self, name: str, rank: Optional[int],
                      is_cv: bool = False) -> None:
        site = _call_site()
        st = self._stack()
        held = []
        seen = set()
        for h_name, h_rank, _t in st:
            if h_name != name and h_name not in seen:
                seen.add(h_name)
                held.append((h_name, h_rank))
        with self._mu:
            self.names.add(name)
            if is_cv:
                self.cv_names.add(name)
            for h_name, h_rank in held:
                self._bump(self.edges, (h_name, name), site)
                if h_rank is not None and rank is not None \
                        and rank < h_rank:
                    self._bump(self.inversions, (h_name, name), site)
        st.append((name, rank, time.perf_counter()))

    def note_released(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                _, _, t0 = st.pop(i)
                dur = time.perf_counter() - t0
                with self._mu:
                    row = self.holds.setdefault(
                        name, {"count": 0, "total_s": 0.0, "max_s": 0.0,
                               "site": _call_site()})
                    row["count"] += 1
                    row["total_s"] += dur
                    if dur > row["max_s"]:
                        row["max_s"] = dur
                        row["site"] = _call_site()
                return

    def note_wait(self, name: str) -> None:
        site = _call_site()
        held = {h for h, _r, _t in self._stack() if h != name}
        if not held:
            return
        with self._mu:
            for h in sorted(held):
                self._bump(self.waits, (h, name), site)

    # ---- analysis -----------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """Simple cycles in the lock-order graph (each reported once,
        starting from its lexicographically smallest node)."""
        with self._mu:
            adj: dict[str, list[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, []).append(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(node: str, path: list[str], on_path: set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    lo = min(range(len(cyc) - 1), key=lambda i: cyc[i])
                    norm = tuple(cyc[lo:-1] + cyc[:lo] + [cyc[lo]])
                    if norm not in seen_cycles:
                        seen_cycles.add(norm)
                        out.append(list(norm))
                elif nxt not in visited:
                    visited.add(nxt)
                    dfs(nxt, path + [nxt], on_path | {nxt})

        visited: set[str] = set()
        for start in sorted(adj):
            if start not in visited:
                visited.add(start)
                dfs(start, [start], {start})
        return out

    def problems(self) -> dict:
        """The gateable subset: cycles and rank inversions."""
        cyc = self.cycles()
        with self._mu:
            inv = [{"held": a, "acquired": b, **row}
                   for (a, b), row in sorted(self.inversions.items())]
        return {"cycles": cyc, "rank_inversions": inv}

    def report(self) -> dict:
        """The full ranked report (most frequent edges first)."""
        problems = self.problems()
        with self._mu:
            edges = [{"from": a, "to": b, **row}
                     for (a, b), row in sorted(
                         self.edges.items(),
                         key=lambda kv: -kv[1]["count"])]
            waits = [{"held": a, "wait_on": b, **row}
                     for (a, b), row in sorted(
                         self.waits.items(),
                         key=lambda kv: -kv[1]["count"])]
            long_holds = [
                {"name": n, **row} for n, row in sorted(
                    self.holds.items(), key=lambda kv: -kv[1]["max_s"])
                if row["max_s"] >= LONG_HOLD_S
                and n not in self.cv_names]
            locks = sorted(self.names)
        return {
            "locks": locks,
            "ranks": {n: LOCK_RANKS.get(n) for n in locks},
            "edges": edges,
            "cycles": problems["cycles"],
            "rank_inversions": problems["rank_inversions"],
            "waits_under_lock": waits,
            "long_holds": long_holds,
        }

    def assert_clean(self) -> None:
        """Raise if the recorded graph has a cycle or rank inversion."""
        p = self.problems()
        if p["cycles"] or p["rank_inversions"]:
            raise AssertionError(
                "lock-order violations recorded:\n"
                + json.dumps(p, indent=2))


#: the process-wide trace every factory-built lock reports into
TRACE = LockTrace()


# ---- traced primitives -------------------------------------------------
class TracedLock:
    """Drop-in ``Lock``/``RLock`` wrapper feeding :data:`TRACE`."""

    def __init__(self, name: str, inner=None, rank: Optional[int] = None,
                 trace: Optional[LockTrace] = None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        self.rank = LOCK_RANKS.get(name) if rank is None else rank
        self._trace = trace if trace is not None else TRACE

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._trace.note_acquired(self.name, self.rank)
        return got

    def release(self) -> None:
        self._trace.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<TracedLock {self.name!r} rank={self.rank}>"


class TracedCondition:
    """Drop-in ``threading.Condition()`` wrapper feeding :data:`TRACE`.

    ``wait``/``wait_for`` additionally record which *other* locks the
    waiter still holds while blocked (waits-under-lock). The wrapped
    condition keeps its own default RLock so wait-time release/reacquire
    semantics are stock CPython.
    """

    def __init__(self, name: str, rank: Optional[int] = None,
                 trace: Optional[LockTrace] = None):
        self.name = name
        self._cond = threading.Condition()
        self.rank = LOCK_RANKS.get(name) if rank is None else rank
        self._trace = trace if trace is not None else TRACE

    def acquire(self, *args) -> bool:
        got = self._cond.acquire(*args)
        if got:
            self._trace.note_acquired(self.name, self.rank, is_cv=True)
        return got

    def release(self) -> None:
        self._trace.note_released(self.name)
        self._cond.release()

    def __enter__(self) -> "TracedCondition":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._trace.note_wait(self.name)
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._trace.note_wait(self.name)
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<TracedCondition {self.name!r} rank={self.rank}>"


# ---- factories (what repro.core constructs every lock through) ---------
def make_lock(name: str, rank: Optional[int] = None):
    """A named mutex: plain ``threading.Lock`` when tracing is off."""
    if not enabled():
        return threading.Lock()
    return TracedLock(name, threading.Lock(), rank=rank)


def make_rlock(name: str, rank: Optional[int] = None):
    """A named reentrant mutex (reentry records no self-edges)."""
    if not enabled():
        return threading.RLock()
    return TracedLock(name, threading.RLock(), rank=rank)


def make_condition(name: str, rank: Optional[int] = None):
    """A named condition variable (its own lock, like
    ``threading.Condition()``)."""
    if not enabled():
        return threading.Condition()
    return TracedCondition(name, rank=rank)


def _dump_at_exit() -> None:
    out = os.environ.get(ENV_OUT)
    if not out or not enabled() or not TRACE.names:
        return
    try:
        with open(out, "w") as f:
            json.dump(TRACE.report(), f, indent=2)
            f.write("\n")
    except OSError:
        pass


atexit.register(_dump_at_exit)
