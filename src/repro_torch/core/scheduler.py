"""Hazard-aware asynchronous task scheduler — the engine's dispatch core.

The paper's Alchemist "can serve several Spark applications at a time"
(§3.1.1); the Cray deployment follow-up (Rothauge et al., 2019) shows the
request-overlap regime is exactly where the bridge wins or loses. The
first engine serialized every command from every session through one FIFO
drained under a dispatch lock, so one client's 50-iteration Lanczos head-of-line-blocked
every other client's 2ms multiply. This module replaces that FIFO with a
task table and a worker pool:

* every submitted command becomes a :class:`Task` moving through
  ``QUEUED -> RUNNING -> DONE | FAILED``;
* tasks from *different* sessions run concurrently on the worker pool;
* correctness constraints are dependency edges, computed at submit time:

  - **program order** — a task depends on the previous task of its own
    session, so one client's calls never reorder or overlap each other;
  - **read/write hazards** — per engine-resident handle, a task that
    *writes* handle H waits for the prior writer and every reader since
    (and later readers wait for it), while concurrent *readers* of H are
    unordered among themselves;
  - **data dependencies** — a task consuming another task's *deferred*
    output (a handle that does not exist yet; see
    ``protocol.DeferredHandle``) waits for the producer, and fails —
    without running — if the producer failed. Only data edges propagate
    failure: a client's failed call never poisons its later, independent
    calls, and never another session's future;
  - **barriers** — a barrier task (engine library loading) waits for every
    in-flight task, and every later task waits for it.

The scheduler is engine-agnostic: it runs ``task.fn(task)`` thunks and
records per-task queue-wait vs execute time, leaving protocol encoding to
the engine. ``max_running_observed`` exposes the concurrency high-water
mark so tests and the multi-client benchmark can prove overlap is real.

For the backend ABI's chain fusion (``core/backends``), a running task
may *claim* the chain of queued tasks that depend only on it
(:meth:`TaskScheduler.claim_chain`) and execute them inside itself as
one fused program, completing each via :meth:`finish_claimed`; claiming
honours every edge in the table, so orderings against other sessions'
writes are preserved — an interleaved hazard simply stops the claim.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Iterable, Optional

from repro_torch.analysis import locktrace, statemachine
from repro_torch.common import spans
from repro_torch.core.qos.policy import FifoReadyQueue

QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"


class TaskFailure(Exception):
    """Raised by a task body to fail the task while keeping a payload
    (e.g. an already-encoded error Result) available to waiters."""

    def __init__(self, payload: Any, message: str = ""):
        super().__init__(message or "task failed")
        self.payload = payload


@dataclasses.dataclass
class Task:
    """One row of the task table.

    ``deps`` is the number of unfinished dependency edges; the task
    becomes runnable at zero. ``data_deps`` names producer tasks whose
    failure must propagate here (deferred-handle edges only).
    ``wait_s``/``exec_s`` split the task's latency into time spent queued
    behind dependencies and worker availability vs time actually running.
    ``traced`` says whether a ``torch.profiler`` recorded on the thread
    that submitted it (``submit_tid``): its spans are then recorded
    (``common/spans.py``) from the stamps below, ``executed_at`` being
    where the routine's work ended and the hand-back began.
    """
    id: int
    session: int
    fn: Callable[["Task"], Any]
    label: str = ""
    barrier: bool = False
    state: str = QUEUED
    deps: int = 0
    dep_ids: tuple[int, ...] = ()     # the dependency edges, by task id
    data_deps: tuple[int, ...] = ()
    reads: tuple[int, ...] = ()       # handle ids, for hazard-map pruning
    writes: tuple[int, ...] = ()
    # opaque caller state: the engine stores the decoded Command here,
    # which is what chain claiming hands back for fused execution
    payload: Any = None
    # estimated execute-seconds (cost model price) — what the fair-share
    # policy charges the session's virtual time at dispatch; 0.0 when
    # QoS is off (the engine skips pricing entirely)
    price: float = 0.0
    dependents: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    started_at: float = 0.0
    executed_at: float = 0.0
    finished_at: float = 0.0
    traced: bool = False
    submit_tid: int = 0
    wait_s: float = 0.0
    exec_s: float = 0.0
    result: Any = None
    error: str = ""


class TaskScheduler:
    """Task table + dependency edges + worker-thread pool.

    ``num_workers=1`` degenerates to the PR-1 serialized dispatch (still
    hazard- and order-correct) — the baseline the multi-client throughput
    benchmark compares against. ``on_finish`` is called (outside the
    scheduler lock) with each task as it completes, in completion order —
    the engine uses it for per-task cost accounting.

    ``policy`` selects which ready task a freed worker picks: the
    default :class:`~repro.core.qos.policy.FifoReadyQueue` reproduces
    the original ready deque exactly; a
    :class:`~repro.core.qos.policy.FairShareQueue` dispatches by
    weighted virtual time (multi-tenant QoS). The policy object is
    mutated only under the scheduler's condition variable and must
    never call into the engine.
    """

    def __init__(self, num_workers: int = 4,
                 on_finish: Optional[Callable[[Task], None]] = None,
                 policy=None):
        self.num_workers = max(1, int(num_workers))
        self.on_finish = on_finish
        self._cv = locktrace.make_condition("scheduler.cv")
        self._tasks: dict[int, Task] = {}
        self._ids = itertools.count(1)
        self._ready = policy if policy is not None else FifoReadyQueue()
        self._session_tail: dict[int, int] = {}
        self._barrier_tail: Optional[int] = None
        self._writer: dict[int, int] = {}          # handle id -> last writer
        self._readers: dict[int, set[int]] = {}    # handle id -> readers since
        self._threads: list[threading.Thread] = []
        self._finished: collections.deque[Task] = collections.deque()
        self._cb_lock = locktrace.make_lock("scheduler.delivery")
        # Lifecycle monitor (repro.analysis.statemachine): bound once at
        # construction, no-op unless REPRO_STM_TRACE=1. The owning engine
        # overwrites _stm_domain with its own identity so two engines in
        # one process never collide in the monitor's key space.
        self._stm = statemachine.tracer()
        self._stm_domain: int = 0
        self._shutdown = False
        self._paused = False
        self._running = 0
        self.max_running_observed = 0

    # ---- submission -----------------------------------------------------
    def submit(self, fn: Callable[[Task], Any], *, session: int = 0,
               reads: Iterable[int] = (), writes: Iterable[int] = (),
               data_deps: Iterable[int] = (), barrier: bool = False,
               label: str = "", payload: Any = None,
               price: float = 0.0) -> Task:
        """Add a task; returns immediately with the QUEUED task.

        ``reads``/``writes`` are engine handle IDs the task will resolve
        (write implies read); ``data_deps`` are producer task IDs whose
        deferred outputs the task consumes; ``barrier=True`` serializes
        against every in-flight task, before and after. ``payload`` is
        opaque caller state carried on the row (chain claiming returns
        it to the caller).
        """
        reads, writes = set(reads), set(writes)
        reads -= writes
        traced = spans.profiling()
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            task = Task(id=next(self._ids), session=session, fn=fn,
                        label=label, barrier=barrier,
                        data_deps=tuple(dict.fromkeys(data_deps)),
                        reads=tuple(reads), writes=tuple(writes),
                        payload=payload, price=float(price),
                        submitted_at=time.perf_counter(), traced=traced,
                        submit_tid=spans.thread_id() if traced else 0)
            deps: set[int] = set()

            def live(tid: Optional[int]) -> bool:
                t = self._tasks.get(tid) if tid is not None else None
                return t is not None and t.state in (QUEUED, RUNNING)

            prev = self._session_tail.get(session)
            if live(prev):
                deps.add(prev)
            if live(self._barrier_tail):
                deps.add(self._barrier_tail)
            if barrier:
                deps.update(t.id for t in self._tasks.values()
                            if t.state in (QUEUED, RUNNING))
                self._barrier_tail = task.id
            for h in reads:
                if live(self._writer.get(h)):
                    deps.add(self._writer[h])
                self._readers.setdefault(h, set()).add(task.id)
            for h in writes:
                if live(self._writer.get(h)):
                    deps.add(self._writer[h])
                deps.update(t for t in self._readers.get(h, ())
                            if live(t) and t != task.id)
                self._writer[h] = task.id
                self._readers[h] = set()
            for tid in task.data_deps:
                if live(tid):
                    deps.add(tid)
            deps.discard(task.id)

            self._tasks[task.id] = task
            if self._stm.enabled:
                self._stm.mint("task", (self._stm_domain, task.id),
                               site="submit",
                               scope=(self._stm_domain, session))
            self._session_tail[session] = task.id
            task.deps = len(deps)
            task.dep_ids = tuple(sorted(deps))
            for d in deps:
                self._tasks[d].dependents.append(task.id)
            # A data dep on an already-terminal producer gates nothing,
            # but this task still resolves its deferred inputs from that
            # row when it runs: record the dependency anyway so
            # release() keeps the producer's row until this task is
            # terminal too. Without the edge, a concurrent result
            # delivery (wait -> release) between this submit and our
            # execution drops the row and resolution fails with
            # "unknown task".
            for tid in task.data_deps:
                t = self._tasks.get(tid)
                if t is not None and tid not in deps:
                    t.dependents.append(task.id)
            if task.deps == 0:
                self._ready.push(task)
            self._spawn_workers()
            self._cv.notify_all()
            return task

    # ---- inspection -----------------------------------------------------
    def task(self, task_id: int) -> Task:
        with self._cv:
            t = self._tasks.get(task_id)
            if t is None:
                raise KeyError(f"unknown task #{task_id}")
            return t

    def counts(self) -> dict[str, int]:
        """Number of tasks per state (a snapshot of the task table)."""
        with self._cv:
            c = collections.Counter(t.state for t in self._tasks.values())
            return {s: c.get(s, 0) for s in (QUEUED, RUNNING, DONE, FAILED)}

    def release(self, task_id: int) -> bool:
        """Drop one *terminal* task row after its result was delivered —
        long-lived sessions issuing blocking calls must not accumulate
        table rows (the old FIFO popped results on delivery too). The
        row is kept while any dependent is still queued/running (failure
        propagation and deferred resolution read it) and dropped at
        disconnect otherwise. Returns True if the row was removed."""
        with self._cv:
            t = self._tasks.get(task_id)
            if t is None:
                return True
            if t.state not in (DONE, FAILED):
                return False
            for d in t.dependents:
                dep = self._tasks.get(d)
                if dep is not None and dep.state in (QUEUED, RUNNING):
                    return False
            if self._stm.enabled:
                self._stm.note("task", (self._stm_domain, task_id),
                               "RELEASED", site="release")
            del self._tasks[task_id]
            if self._session_tail.get(t.session) == task_id:
                self._session_tail.pop(t.session, None)
            return True

    def forget_session(self, session: int) -> int:
        """Drop a departed session's *terminal* tasks (and their retained
        results) from the table — the engine calls this on disconnect,
        after draining, so the table stays bounded by connected tenants'
        work. Task results are retained until then: waiters and deferred
        consumers resolve against them. Returns the number dropped."""
        with self._cv:
            gone = [tid for tid, t in self._tasks.items()
                    if t.session == session and t.state in (DONE, FAILED)]
            for tid in gone:
                if self._stm.enabled:
                    self._stm.note("task", (self._stm_domain, tid),
                                   "RELEASED", site="forget_session")
                del self._tasks[tid]
            if self._session_tail.get(session) is not None and \
                    self._session_tail[session] not in self._tasks:
                self._session_tail.pop(session, None)
            self._ready.forget_session(session)
            return len(gone)

    def session_depth(self, session: int) -> int:
        """QUEUED + RUNNING task count for one session — the queue-depth
        number admission control checks against a tenant's quota."""
        with self._cv:
            return sum(1 for t in self._tasks.values()
                       if t.session == session
                       and t.state in (QUEUED, RUNNING))

    def set_weight(self, session: int, weight: float) -> None:
        """Set a session's fair-share weight on the dispatch policy
        (no-op under the default FIFO policy)."""
        with self._cv:
            self._ready.set_weight(session, weight)

    def should_yield(self, session: int) -> bool:
        """Ask the dispatch policy whether a long task of this session
        should yield at its next iteration boundary (a lighter tenant's
        virtual time is far behind). Always False under FIFO."""
        with self._cv:
            return self._ready.should_yield(session)

    def ready_depths(self) -> dict:
        """Per-session ready-queue depths (diagnostics; empty under the
        default FIFO policy, which keeps no per-session state)."""
        with self._cv:
            depths = getattr(self._ready, "depths", None)
            return depths() if depths is not None else {}

    def running(self) -> int:
        with self._cv:
            return self._running

    # ---- chain claiming (backend fusion support) ------------------------
    def claim_chain(self, lead_id: int,
                    predicate: Callable[[Task], bool],
                    limit: int = 64) -> list[Task]:
        """Claim the dependency chain hanging off a RUNNING task, so the
        caller can execute it *inside* that task (the engine fuses the
        chain into one backend program).

        A QUEUED task is claimable when every one of its unfinished
        dependency edges points into the claimed set (so by the time the
        fused program runs, nothing else it was ordered after is still
        outstanding), it belongs to the lead's session, it is not a
        barrier, none of its data dependencies failed, and ``predicate``
        (the engine's fusibility check) accepts it. Claimed tasks are
        moved to RUNNING here — no worker will pop them — and MUST each
        be completed later with :meth:`finish_claimed`.

        The walk extends one task at a time from the chain's tail, so it
        claims exactly the straight-line (or diamond-within-chain)
        suffix a lazy client submitted in one burst; anything with an
        edge outside the chain — another session's interleaved write, an
        unfinished unrelated producer — stops the claim, preserving
        every ordering the task table encodes.
        """
        chain: list[Task] = []
        with self._cv:
            lead = self._tasks.get(lead_id)
            if lead is None or lead.state != RUNNING or lead.barrier:
                return chain
            claimed = {lead_id}
            tail = lead
            while len(chain) < limit:
                nxt = None
                for did in tail.dependents:
                    d = self._tasks.get(did)
                    if d is None or d.state != QUEUED or d.barrier or \
                            d.session != lead.session:
                        continue
                    pending = [dep for dep in d.dep_ids
                               if (pt := self._tasks.get(dep)) is not None
                               and pt.state in (QUEUED, RUNNING)]
                    if not pending or not all(p in claimed
                                              for p in pending):
                        continue
                    if any((pt := self._tasks.get(x)) is not None
                           and pt.state == FAILED for x in d.data_deps):
                        continue
                    if not predicate(d):
                        continue
                    if nxt is None or d.id < nxt.id:
                        nxt = d
                if nxt is None:
                    break
                now = time.perf_counter()
                nxt.state = RUNNING
                if self._stm.enabled:
                    self._stm.note("task", (self._stm_domain, nxt.id),
                                   RUNNING, site="claim_chain")
                nxt.started_at = now
                nxt.wait_s = now - nxt.submitted_at
                chain.append(nxt)
                claimed.add(nxt.id)
                tail = nxt
        return chain

    def finish_claimed(self, task_id: int, result: Any = None,
                       state: str = DONE, error: str = "") -> None:
        """Complete one task previously claimed by :meth:`claim_chain`:
        record its result/error, cascade its dependents and hazard
        bookkeeping exactly as if a worker had run it (it never occupied
        a worker slot, so the running count is untouched)."""
        with self._cv:
            task = self._tasks.get(task_id)
            if task is None or task.state != RUNNING:
                raise KeyError(
                    f"task #{task_id} is not a claimed RUNNING task")
        self._finish(task, state, result, error, worker=False)

    def pending_writers(self, handles: Iterable[int]) -> bool:
        """True if any of the given engine-handle IDs has a QUEUED/RUNNING
        *writer* task. The engine's cache fast path checks this before
        serving a memoized result at submit time: hazard edges only order
        scheduled tasks, and a DONE-on-submit hit bypasses scheduling —
        so a hit must never be served while a write it would have been
        ordered after is still in flight."""
        with self._cv:
            for h in handles:
                t = self._tasks.get(self._writer.get(h, -1))
                if t is not None and t.state in (QUEUED, RUNNING):
                    return True
        return False

    def pending_barrier(self) -> bool:
        """True while a barrier task (library loading) is QUEUED/RUNNING.
        The cache fast path refuses hits then, for the same reason as
        :meth:`pending_writers`: a barrier submitted earlier must take
        effect (e.g. re-registering a library invalidates its memoized
        results) before any later command is served."""
        with self._cv:
            t = self._tasks.get(self._barrier_tail) \
                if self._barrier_tail is not None else None
            return t is not None and t.state in (QUEUED, RUNNING)

    # ---- waiting --------------------------------------------------------
    def wait(self, task_id: int, timeout: Optional[float] = None) -> Task:
        """Block until the task reaches DONE or FAILED; returns it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            t = self._tasks.get(task_id)
            if t is None:
                raise KeyError(f"unknown task #{task_id}")
            while t.state in (QUEUED, RUNNING):
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"task #{task_id} still {t.state} after {timeout}s")
                self._cv.wait(remaining)
            return t

    def wait_session(self, session: int,
                     timeout: Optional[float] = None) -> None:
        """Block until the session has no QUEUED/RUNNING tasks (used by
        disconnect so teardown never races in-flight work)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            def pending():
                return [t for t in self._tasks.values()
                        if t.session == session
                        and t.state in (QUEUED, RUNNING)]
            while pending():
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"session #{session} still has {len(pending())} "
                        f"in-flight tasks after {timeout}s")
                self._cv.wait(remaining)

    def pause(self) -> None:
        """Stop popping ready tasks (submissions still accepted). Lets a
        caller land a whole burst in the table before dispatch starts —
        how benchmarks and tests make chain claiming deterministic
        instead of racing the first task against later submissions."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        """Undo :meth:`pause`; wakes the worker pool."""
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def shutdown(self) -> None:
        """Stop accepting tasks and join the worker threads. In-flight
        tasks finish; QUEUED tasks are failed."""
        with self._cv:
            self._shutdown = True
            for t in self._tasks.values():
                if t.state == QUEUED:
                    t.state = FAILED
                    if self._stm.enabled:
                        self._stm.note("task", (self._stm_domain, t.id),
                                       FAILED, site="shutdown")
                    t.error = "scheduler shut down"
                    t.finished_at = time.perf_counter()
            self._ready.clear()
            self._cv.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)

    # ---- worker pool ----------------------------------------------------
    def _spawn_workers(self) -> None:
        # Lazy spawn (under the lock): engines that never dispatch a task
        # never pay for idle threads.
        while len(self._threads) < self.num_workers:
            th = threading.Thread(target=self._worker, daemon=True,
                                  name=f"alchemist-worker-{len(self._threads)}")
            self._threads.append(th)
            th.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while (not self._ready or self._paused) \
                        and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._ready:
                    return
                task = self._tasks[self._ready.pop()]
                task.state = RUNNING
                if self._stm.enabled:
                    self._stm.note("task", (self._stm_domain, task.id),
                                   RUNNING, site="_worker")
                task.started_at = time.perf_counter()
                task.wait_s = task.started_at - task.submitted_at
                self._running += 1
                self.max_running_observed = max(self.max_running_observed,
                                                self._running)
                # a pruned (forgotten) data dep is not failed — if the
                # task truly needs its result, resolution fails cleanly
                failed = next(
                    ((d, t.error) for d in task.data_deps
                     if (t := self._tasks.get(d)) is not None
                     and t.state == FAILED), None)
            if failed is not None:
                self._finish(task, FAILED, None,
                             f"upstream task #{failed[0]} failed: "
                             f"{failed[1]}")
                continue
            execute = spans.enter_job(task.id, task.traced,
                                      task.started_at)
            try:
                result = task.fn(task)
            except TaskFailure as e:
                self._finish(task, FAILED, e.payload, str(e))
            except Exception as e:  # total barrier: a crashing task body
                self._finish(task, FAILED, None,     # must not kill workers
                             f"{type(e).__name__}: {e}")
            else:
                self._finish(task, DONE, result, "")
            spans.leave_job(execute, task)

    def _finish(self, task: Task, state: str, result: Any,
                error: str, worker: bool = True) -> None:
        with self._cv:
            task.finished_at = time.perf_counter()
            task.exec_s = task.finished_at - task.started_at
            task.state = state
            if self._stm.enabled:
                self._stm.note("task", (self._stm_domain, task.id),
                               state, site="_finish")
            task.result = result
            task.error = error
            # fair-share reconciliation: measured exec_s vs the price
            # charged at dispatch (no-op on the default FIFO policy)
            self._ready.task_done(task)
            if worker:          # claimed tasks never held a worker slot
                self._running -= 1
            for dep_id in task.dependents:
                dep = self._tasks.get(dep_id)
                if dep is None:                # forgotten with its session
                    continue
                dep.deps -= 1
                if dep.deps == 0 and dep.state == QUEUED:
                    self._ready.push(dep)
            # hazard maps track only live constraints: a finished task
            # imposes none, so drop its entries (bounds both maps by the
            # in-flight task count)
            for h in task.reads:
                readers = self._readers.get(h)
                if readers is not None:
                    readers.discard(task.id)
                    if not readers:
                        self._readers.pop(h, None)
            for h in task.writes:
                if self._writer.get(h) == task.id:
                    self._writer.pop(h, None)
                if not self._readers.get(h):
                    self._readers.pop(h, None)
            if self.on_finish is not None:
                self._finished.append(task)    # ordered under the lock
        # Deliver on_finish strictly in completion order, and BEFORE
        # waking waiters: a client unblocked by this completion must be
        # able to read the task's cost record the moment it holds the
        # result (TaskLog accounting is part of the observable outcome).
        # Completions enqueue under the scheduler lock above, and
        # whichever worker holds the callback lock drains the queue
        # head-first (a worker may deliver another worker's completion —
        # order is what's guaranteed, not the delivering thread).
        if self.on_finish is not None:
            with self._cb_lock:
                while True:
                    with self._cv:
                        if not self._finished:
                            break
                        done = self._finished.popleft()
                    try:
                        self.on_finish(done)
                    except Exception:   # accounting must never kill a
                        pass            # worker
        with self._cv:
            self._cv.notify_all()
