"""Ready-queue dispatch policies for the task scheduler.

The scheduler keeps exactly one policy object behind its ``_ready``
attribute and mutates it **only under its own condition variable** —
policies therefore carry no locks of their own, and must never call
back into the engine (the same constraint as the scheduler's fusibility
predicate: the engine state lock ranks *below* ``scheduler.cv``).

Two implementations:

* :class:`FifoReadyQueue` — the default. A thin wrapper over the same
  ``collections.deque`` the scheduler always used: ``push`` appends the
  task id, ``pop`` takes the head. Dispatch order with QoS disabled is
  bit-for-bit what it was before this module existed.
* :class:`FairShareQueue` — weighted fair share by virtual time
  (stride scheduling): one FIFO per session, and ``pop`` picks the
  active session with the smallest virtual time, charging it the cost
  model's price estimate for the dispatched task divided by the
  session's weight. A heavy tenant's expensive SVD advances its clock
  far ahead, so a light tenant's cheap calls keep winning the pick —
  proportionally to the configured weights. Estimates are reconciled
  against measured ``exec_s`` on completion (:meth:`task_done`), so a
  tenant whose work is systematically under-priced accumulates the
  difference as *debt* on its clock instead of out-scheduling its
  share.
"""
from __future__ import annotations

import collections
from typing import Optional

from repro_torch.core import costmodel

#: a session re-activating after idling starts at the current virtual
#: clock, never behind it — idle time earns no credit (standard
#: start-time fair queueing; without the floor an idle tenant could
#: burst unboundedly on its stale low clock)
_EPS = 1e-12


class FifoReadyQueue:
    """The scheduler's original ready deque, behind the policy surface.

    Every method is a direct translation of the pre-QoS code: ``push``
    is ``deque.append(task.id)``, ``pop`` is ``deque.popleft()`` —
    identical dispatch order, identical semantics, no accounting.
    """

    def __init__(self):
        self._ready: collections.deque[int] = collections.deque()

    def push(self, task) -> None:
        self._ready.append(task.id)

    def pop(self) -> int:
        return self._ready.popleft()

    def clear(self) -> None:
        self._ready.clear()

    def __len__(self) -> int:
        return len(self._ready)

    def __bool__(self) -> bool:
        return bool(self._ready)

    # QoS hooks: deliberate no-ops on the default policy
    def task_done(self, task) -> None:
        pass

    def set_weight(self, session: int, weight: float) -> None:
        pass

    def should_yield(self, session: int) -> bool:
        return False

    def forget_session(self, session: int) -> None:
        pass


class FairShareQueue:
    """Weighted fair-share ready queue (stride / virtual-time).

    ``log`` (a ``costmodel.QosLog``) receives one ``complete`` record
    per reconciled task — wait time and debt, tagged with the session's
    weight class. The log's own lock ranks 40, above ``scheduler.cv``
    (20), so recording under the scheduler lock is rank-legal.
    """

    def __init__(self, log: Optional[costmodel.QosLog] = None,
                 yield_threshold_s: float = 0.05):
        self._queues: dict[int, collections.deque] = {}
        self._vtime: dict[int, float] = {}
        self._weights: dict[int, float] = {}
        self._charged: dict[int, tuple[int, float]] = {}
        self._clock = 0.0             # vtime of the last dispatched pick
        self._size = 0
        self.log = log
        self.yield_threshold_s = float(yield_threshold_s)

    # ---- policy surface (called under scheduler.cv) -------------------
    def push(self, task) -> None:
        s = task.session
        q = self._queues.get(s)
        if q is None:
            q = self._queues[s] = collections.deque()
        if not q:
            # (re)activation: floor the clock to now — idle time is not
            # banked as future priority
            self._vtime[s] = max(self._vtime.get(s, 0.0), self._clock)
        price = getattr(task, "price", 0.0) or costmodel.TASK_DISPATCH_S
        q.append((task.id, price))
        self._size += 1

    def pop(self) -> int:
        s = min((s for s, q in self._queues.items() if q),
                key=lambda s: (self._vtime.get(s, 0.0), s))
        task_id, price = self._queues[s].popleft()
        self._size -= 1
        self._clock = max(self._clock, self._vtime.get(s, 0.0))
        self._vtime[s] = self._vtime.get(s, 0.0) + price / self._weight(s)
        self._charged[task_id] = (s, price)
        return task_id

    def clear(self) -> None:
        self._queues.clear()
        self._charged.clear()
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def __bool__(self) -> bool:
        return self._size > 0

    # ---- QoS hooks -----------------------------------------------------
    def task_done(self, task) -> None:
        """Reconcile the dispatch-time estimate against the measured
        ``exec_s``: the difference lands on the session's clock as debt
        (or refund), so estimation error cannot tilt the share."""
        charged = self._charged.pop(task.id, None)
        if charged is None:
            return                      # claimed into a chain, or FIFO-era
        s, price = charged
        debt = float(task.exec_s) - price
        v = self._vtime.get(s, 0.0) + debt / self._weight(s)
        # never refund below the global clock: a wildly over-estimated
        # task must not bank future priority for its session
        self._vtime[s] = max(v, 0.0)
        if self.log is not None:
            self.log.record(session=s, event="complete",
                            weight=self._weight(s),
                            wait_s=float(task.wait_s), debt_s=debt)

    def set_weight(self, session: int, weight: float) -> None:
        self._weights[session] = max(float(weight), _EPS)

    def should_yield(self, session: int) -> bool:
        """True when some *other* session has ready work and trails this
        session's virtual time by more than the yield threshold — the
        signal a long-running task's iteration-boundary ``yield_check``
        acts on."""
        mine = self._vtime.get(session, 0.0)
        for s, q in self._queues.items():
            if s != session and q and \
                    mine - self._vtime.get(s, 0.0) > self.yield_threshold_s:
                return True
        return False

    def forget_session(self, session: int) -> None:
        q = self._queues.pop(session, None)
        if q:
            self._size -= len(q)
        self._vtime.pop(session, None)
        self._weights.pop(session, None)

    # ---- internals -----------------------------------------------------
    def _weight(self, session: int) -> float:
        return self._weights.get(session, 1.0)

    def depths(self) -> dict[int, int]:
        """Ready-queue depth per session (diagnostics)."""
        return {s: len(q) for s, q in self._queues.items() if q}
