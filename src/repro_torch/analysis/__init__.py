"""repro_torch.analysis — the runtime halves of the JAX package's
invariant checks: the lock-order tracer (``locktrace``) and the lifecycle
state-machine monitor (``statemachine``), which the engine, scheduler and
cost model construct their locks and monitors through. Both are no-ops
unless ``REPRO_LOCK_TRACE`` / ``REPRO_STM_TRACE`` is set. The static rule
pass is a later slice of the port."""

__all__ = ["locktrace", "statemachine"]
