"""Admission control: per-tenant saturation quotas with retry hints.

An unbounded engine lets one tenant queue work faster than the workers
drain it — every other tenant's wait time then grows without limit, and
a vanished client leaves megabytes of staged upload behind. The
controller bounds three things per session, checked *before* any state
is committed:

* **queue depth** — QUEUED + RUNNING tasks in the scheduler
  (checked at ``engine.submit``);
* **in-flight upload bytes** — reserved at ``UPLOAD_BEGIN``, released
  at commit/abort/disconnect (the data-plane backpressure);
* **resident handle bytes** — store bytes owned by the session
  (checked at submit: a tenant over its memory quota must free or
  fetch before computing more).

A denied request costs the client one round trip and a typed
``AlchemistBusyError`` whose ``retry_after_s`` estimates when capacity
frees up — the client backs off instead of erroring (see
``context._submit``). Quotas are engine-wide defaults
(``AlchemistEngine(qos_quotas=...)``) with per-session overrides via
``configure(quotas=...)``.

The controller's lock is ``qos.admission`` (rank 12): taken from the
submit/upload paths between the engine state lock (10) and the
scheduler (20), and never while holding either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis import locktrace
from repro_torch.core import costmodel

#: bounds on the retry_after_s hint: never so small the client
#: busy-spins, never so large a transient spike parks it for good
_RETRY_MIN_S = 0.05
_RETRY_MAX_S = 5.0

#: quota knobs a `configure(quotas={...})` call may set
QUOTA_KEYS = ("max_queue_depth", "max_inflight_bytes",
              "max_resident_bytes")


@dataclasses.dataclass(frozen=True)
class QuotaConfig:
    """Per-tenant saturation limits; ``None`` disables that check."""
    max_queue_depth: Optional[int] = None
    max_inflight_bytes: Optional[int] = None
    max_resident_bytes: Optional[int] = None

    def merged(self, overrides: dict) -> "QuotaConfig":
        """This config with the given knobs replaced (validated keys
        only — callers validate before merging)."""
        return dataclasses.replace(self, **overrides)


class AdmissionController:
    """Tracks per-session quota overrides and in-flight upload
    reservations; answers admit/deny with a retry hint. Stateless about
    queue depth and resident bytes — the engine measures those and
    passes them in, so the controller never reaches into engine or
    scheduler locks."""

    def __init__(self, defaults: Optional[QuotaConfig] = None,
                 log: Optional[costmodel.QosLog] = None):
        self.defaults = defaults if defaults is not None else QuotaConfig()
        self.log = log
        self._lock = locktrace.make_lock("qos.admission")
        self._overrides: dict[int, QuotaConfig] = {}
        self._inflight: dict[int, int] = {}

    # ---- configuration -------------------------------------------------
    def quota_for(self, session: int) -> QuotaConfig:
        with self._lock:
            return self._overrides.get(session, self.defaults)

    def set_quota(self, session: int, overrides: dict) -> QuotaConfig:
        """Apply per-session knobs over the engine defaults (validated
        by ``engine.configure`` before this is called)."""
        with self._lock:
            base = self._overrides.get(session, self.defaults)
            cfg = base.merged(overrides)
            self._overrides[session] = cfg
            return cfg

    def forget_session(self, session: int) -> int:
        """Disconnect reclaim: drop the session's quota override and
        every outstanding upload reservation (a client that vanished
        while throttled must not leak reserved bytes). Returns the
        reclaimed reservation bytes."""
        with self._lock:
            self._overrides.pop(session, None)
            return self._inflight.pop(session, 0)

    # ---- admission checks ----------------------------------------------
    def admit_submit(self, session: int, weight: float, queue_depth: int,
                     resident_bytes: int, est_exec_s: float = 0.0
                     ) -> Optional[tuple[str, float]]:
        """None = admitted; else ``(reason, retry_after_s)``. The hint
        scales with how much queued work must drain before capacity
        frees: depth × the estimated per-task execute time, bounded."""
        quota = self.quota_for(session)
        reason = None
        if quota.max_queue_depth is not None and \
                queue_depth >= quota.max_queue_depth:
            reason = (f"session #{session} queue depth {queue_depth} at "
                      f"quota {quota.max_queue_depth}")
        elif quota.max_resident_bytes is not None and \
                resident_bytes > quota.max_resident_bytes:
            reason = (f"session #{session} resident {resident_bytes} bytes "
                      f"over quota {quota.max_resident_bytes}")
        if reason is None:
            if self.log is not None:
                self.log.record(session=session, event="admitted",
                                weight=weight)
            return None
        retry = self._retry_hint(queue_depth, est_exec_s)
        if self.log is not None:
            self.log.record(session=session, event="rejected",
                            weight=weight, reason=reason)
        return reason, retry

    def reserve_upload(self, session: int, nbytes: int,
                       weight: float = 1.0
                       ) -> Optional[tuple[str, float]]:
        """Reserve in-flight bytes for a staged upload; None = reserved,
        else ``(reason, retry_after_s)`` and nothing is reserved."""
        nbytes = max(int(nbytes), 0)
        with self._lock:
            quota = self._overrides.get(session, self.defaults)
            held = self._inflight.get(session, 0)
            if quota.max_inflight_bytes is not None and \
                    held + nbytes > quota.max_inflight_bytes:
                reason = (f"session #{session} in-flight upload bytes "
                          f"{held + nbytes} over quota "
                          f"{quota.max_inflight_bytes}")
            else:
                self._inflight[session] = held + nbytes
                reason = None
        if reason is None:
            return None
        if self.log is not None:
            self.log.record(session=session, event="throttled",
                            weight=weight, reason=reason)
        return reason, _RETRY_MIN_S * 4

    def release_upload(self, session: int, nbytes: int) -> None:
        """Release a reservation (commit, abort, or teardown)."""
        with self._lock:
            held = self._inflight.get(session, 0)
            left = max(held - max(int(nbytes), 0), 0)
            if left:
                self._inflight[session] = left
            else:
                self._inflight.pop(session, None)

    def inflight_bytes(self, session: int) -> int:
        with self._lock:
            return self._inflight.get(session, 0)

    @staticmethod
    def _retry_hint(queue_depth: int, est_exec_s: float) -> float:
        est = max(float(est_exec_s), costmodel.TASK_DISPATCH_S)
        return min(max(queue_depth * est, _RETRY_MIN_S), _RETRY_MAX_S)
