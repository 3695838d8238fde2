"""Pluggable execution backends (the Backend ABI; see ``base.py``).

The registry maps backend names to :class:`~.base.ExecutionBackend`
classes. An engine instantiates every registered backend at
construction; a client selects one per session over the ``configure``
protocol endpoint (``AlchemistContext(backend="reference")``), defaulting
to :data:`DEFAULT_BACKEND`.

Bundled backends:

* ``torch`` — eager PyTorch on the engine's device, the port's CUDA
  kernels for CUDA tensors (the default; no fusion yet);
* ``reference`` — plain numpy, sequential, no fusion: the conformance
  oracle and debugging tool.
"""
from __future__ import annotations

from repro_torch.core.backends.base import (
    ALI,
    ARRAY,
    BLOCK2D,
    LAYOUTS,
    REPLICATED,
    ROWBLOCK,
    BackendError,
    ExecutionBackend,
    ExecutionPlan,
    Input,
    PlanStep,
    RoutineImpl,
    StepRef,
)
from repro_torch.core.backends.reference import ReferenceBackend
from repro_torch.core.backends.torch_backend import TorchBackend

DEFAULT_BACKEND = "torch"

_REGISTRY: dict[str, type] = {
    TorchBackend.name: TorchBackend,
    ReferenceBackend.name: ReferenceBackend,
}

__all__ = [
    "ALI", "ARRAY", "BLOCK2D", "LAYOUTS", "REPLICATED", "ROWBLOCK",
    "BackendError", "DEFAULT_BACKEND", "ExecutionBackend", "ExecutionPlan",
    "Input", "PlanStep", "ReferenceBackend", "RoutineImpl", "StepRef",
    "TorchBackend", "available_backends", "create_backend", "create_backends",
    "register_backend",
]


def register_backend(cls: type) -> type:
    """Class decorator adding a third-party backend to the registry."""
    if not cls.name:
        raise BackendError("backend classes must declare a non-empty name")
    _REGISTRY[cls.name] = cls
    return cls


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def create_backend(name: str) -> ExecutionBackend:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise BackendError(
            f"unknown execution backend {name!r} "
            f"(available: {', '.join(available_backends())})")
    return cls()


def create_backends() -> dict[str, ExecutionBackend]:
    """One fresh instance of every registered backend (what an engine
    builds at construction — instances are per-engine so compile caches
    never leak across engines)."""
    return {name: cls() for name, cls in _REGISTRY.items()}
