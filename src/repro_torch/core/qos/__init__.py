"""Multi-tenant quality of service: the layer between the protocol
endpoints and the scheduler that keeps a shared engine fair under
heavy-tailed tenant mixes (ROADMAP item 2; the regime of the Cray
deployment study, Rothauge et al. 2019 — many client frameworks
attached to one long-lived accelerator service).

Three cooperating pieces, all default-off (an engine constructed
without ``qos=True`` is behaviorally identical to the plain scheduler):

* :class:`~repro.core.qos.policy.FairShareQueue` — weighted fair-share
  (stride / virtual-time) dispatch over per-session ready queues,
  replacing the scheduler's FIFO pick. Each dispatched task charges its
  session's virtual time with the cost model's price estimate divided
  by the session's weight; measured ``exec_s`` reconciles the charge on
  completion, so systematically under-estimated tenants cannot
  out-schedule their share. :class:`~repro.core.qos.policy.FifoReadyQueue`
  is the default policy and reproduces the old deque exactly.
* :class:`~repro.core.qos.admission.AdmissionController` — per-tenant
  quotas (queue depth, in-flight upload bytes, resident handle memory)
  checked at submit/upload time; saturation rejects with a typed
  ``AlchemistBusyError`` carrying a ``retry_after_s`` hint instead of
  queueing without bound.
* cooperative preemption — long SVD/CG-class tasks call the
  ``backends.base.yield_check`` hook at iteration boundaries; when the
  fair-share queue says a lighter tenant is far behind, the heavy task
  briefly yields the host (see ``engine._qos_yield``).

Accounting lives in ``costmodel.QosLog`` (admitted / rejected /
throttled / preempted counters, fair-share debt, p50/p99 wait split by
weight class). All locks here go through the ``locktrace`` factories:
``qos.admission`` ranks 12 (between ``engine.state`` and
``scheduler.cv``), and the policy itself is lock-free — it is only ever
mutated under the scheduler's own condition variable.
"""
from repro_torch.core.qos.admission import QUOTA_KEYS, AdmissionController, \
    QuotaConfig
from repro_torch.core.qos.policy import FairShareQueue, FifoReadyQueue

__all__ = [
    "QUOTA_KEYS",
    "AdmissionController",
    "QuotaConfig",
    "FairShareQueue",
    "FifoReadyQueue",
]
