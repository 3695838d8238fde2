"""The Backend ABI — the seam between *what* a routine computes and *how*.

The paper's whole thesis is that one logical routine can run an order of
magnitude faster when handed to a better implementation (Alchemist, KDD
2018), and the follow-ups (Gittens et al., arXiv:1806.01270; Rothauge et
al., arXiv:1910.01354) show the engine must serve several execution
environments behind one interface. Before this package the engine
hardwired one eager jnp implementation per routine inside
``core/libraries/*.py`` — no seam to compare implementations, no way to
exploit the single-burst chains the lazy client already submits.

The split:

* ``core/libraries/*.py`` keep the **specs** — the ``@routine``-decorated
  declarations whose signatures build the wire catalog (unchanged since
  the typed façade; ``describe`` serves exactly what it served before). Their bodies
  are catalog-only and raise if called: the engine never calls a library
  function directly any more.
* each backend registers **implementations**: array-level functions
  (``fn(**kwargs) -> dict``) taking backend-native arrays for matrix
  params, scalars for the rest, returning output arrays plus scalar
  stats. The *engine* owns handle resolution, layout negotiation, and
  minting output handles through its distributed-sharding path — so no
  backend can accidentally return a host-materialized array that drops
  the engine layout (the old ``transpose`` bug, fixed systematically).

An :class:`ExecutionPlan` is what the engine hands a backend: one step
per command, with :class:`Input` placeholders for engine-resident
operands and :class:`StepRef` placeholders for chain-internal data flow.
``compile(plan)`` returns a callable executing the whole plan; the jax
backend compiles a multi-step plan of fusible ops into a **single
``jax.jit`` program** (one dispatch, no intermediate host
materialization) — the headline optimization the scheduler's chain
claiming feeds (see ``engine._run_fused``).

Layouts are declared, not implied: an implementation says which engine
layouts it ``accepts`` for matrix inputs (``None`` = any) and where a
foreign layout must be redistributed to (``relayout_to``); the engine
inserts the explicit relayout step and charges it to the task's cost
accounting (``costmodel.TaskLog`` relayout counters).

Third-party libraries that registered plain ALI callables
(``fn(engine_view, **args)``) still work on every backend: an
unregistered routine resolves to a *legacy* :class:`RoutineImpl`
(``kind="ali"``) wrapping the library function itself — dispatch still
goes through the ABI, the calling convention is just the old one. Legacy
impls are never fused.
"""
from __future__ import annotations

import abc
import dataclasses
import threading
from typing import Any, Callable, Optional

# The engine-side distributed layouts (the Elemental DistMatrix
# vocabulary, projected onto the engine's 1-axis worker mesh):
#   rowblock   — rows sharded over the worker axis (the engine-native
#                layout streamed uploads land in);
#   block2d    — the 2D block-cyclic analogue; on a 1-axis mesh it
#                projects to column blocks (last dim sharded);
#   replicated — a full copy on every worker (small factors, scalars).
# One definition, owned by the handle layer — a backend's ``accepts``
# declaration and the engine's put-time validation must never diverge.
from repro_torch.core.handles import (  # noqa: E402  (re-exported vocabulary)
    BLOCK2D,
    LAYOUTS,
    REPLICATED,
    ROWBLOCK,
)

ARRAY = "array"          # array-level impl: fn(**kwargs) -> dict
ALI = "ali"              # legacy ALI callable: fn(engine_view, **kwargs)


class BackendError(RuntimeError):
    """A backend cannot serve a request (unknown backend name, no
    implementation registered for a routine it was asked to compile)."""


# ---------------------------------------------------------------------------
# cooperative preemption hook (core/qos)
#
# A long iterative routine (truncated SVD's subspace iterations, CG's
# solve loop) would otherwise hold its scheduler worker for its whole
# runtime, starving lighter tenants no matter how the ready queue is
# ordered. The engine installs a per-task hook on the worker thread
# (thread-local: concurrent workers each see their own task's hook) and
# implementations call :func:`yield_check` at iteration boundaries —
# when the fair-share queue says another tenant is far behind, the hook
# briefly yields the host. With QoS off no hook is installed and the
# call is a no-op attribute read.
# ---------------------------------------------------------------------------
_yield_hook = threading.local()


def set_yield_check(fn: Optional[Callable[[], None]]) -> None:
    """Install (or clear, with ``None``) the current worker thread's
    iteration-boundary preemption hook. The engine pairs every install
    with a ``finally`` clear, so a hook never outlives its task."""
    _yield_hook.fn = fn


def yield_check() -> None:
    """Give the scheduler a chance to favor a starved tenant; called by
    iterative implementations between iterations and by plan
    interpreters between steps. No-op unless the engine installed a
    hook for the running task."""
    fn = getattr(_yield_hook, "fn", None)
    if fn is not None:
        fn()


@dataclasses.dataclass(frozen=True)
class RoutineImpl:
    """One backend's implementation of one cataloged routine.

    ``fn`` is the array-level function (or the raw ALI callable when
    ``kind="ali"``). ``fusible`` marks implementations that are pure,
    traceable array programs — what the jax backend may merge into a
    single jitted chain. ``accepts`` is the set of engine layouts the
    matrix inputs may arrive in (``None`` = any); an operand in a
    foreign layout is redistributed to ``relayout_to`` by the engine
    before the implementation runs.

    ``bucketable`` declares that zero-padding every matrix operand up to
    a shape bucket provably preserves the result: the logical block of
    the padded output equals the unpadded output, and pad regions stay
    zero (so padded values compose through chains). True for the linear
    kernels (multiply/add/transpose/gram); false for anything whose
    output *values* depend on operand extents (random generation,
    tiling, QR/eigendecompositions). ``out_shapes`` is the shape rule
    that goes with it — ``fn(shapes: dict[param, shape], **scalars) ->
    dict[output, shape]``, raising on invalid shape combinations — used
    to crop padded program outputs back to their logical shapes and to
    enumerate warmup buckets (see ``core/compilecache.py``).
    """
    fn: Callable[..., Any]
    fusible: bool = False
    accepts: Optional[tuple[str, ...]] = None
    relayout_to: str = ROWBLOCK
    kind: str = ARRAY
    bucketable: bool = False
    out_shapes: Optional[Callable[..., dict]] = None


@dataclasses.dataclass(frozen=True)
class Input:
    """Plan placeholder for an engine-resident operand: the engine
    materializes the handle into the plan's input table under ``slot``."""
    slot: str


@dataclasses.dataclass(frozen=True)
class StepRef:
    """Plan placeholder for chain-internal data flow: the value is output
    ``key`` of plan step ``step`` — never materialized engine-side
    between steps (inside a fused program it is just an SSA edge)."""
    step: int
    key: str


@dataclasses.dataclass
class PlanStep:
    """One routine invocation inside a plan: resolved scalar args plus
    :class:`Input`/:class:`StepRef` placeholders for array operands."""
    library: str
    routine: str
    args: dict[str, Any]
    impl: RoutineImpl


@dataclasses.dataclass
class ExecutionPlan:
    """What the engine compiles through a backend: an ordered list of
    steps where step *i* may reference outputs of steps ``< i``.

    ``input_specs`` maps each :class:`Input` slot to its operand's
    ``(shape, dtype)`` — filled by the engine from the arrays it
    actually materialized (post-bucketing, when bucketing applies).
    """
    steps: list[PlanStep]
    # slot -> (shape tuple, dtype string); None = shapes unknown
    input_specs: Optional[dict[str, tuple[tuple, str]]] = None

    def signature(self) -> Optional[tuple]:
        """Hashable key for compile caching: per step the routine
        identity plus every arg (scalars by value — they are baked into
        the trace; placeholders by position), plus the operand
        shapes/dtypes when known. Two same-structure plans over
        different-shaped operands are *different programs* to XLA — a
        shape-blind key could neither attribute retraces nor address AOT
        bucket executables, so shapes are part of the identity.
        ``None`` when an arg is unhashable (the caller must skip its
        compile cache)."""
        sig = []
        for step in self.steps:
            try:
                args = tuple(sorted(step.args.items(),
                                    key=lambda kv: kv[0]))
                hash(args)          # unhashable arg -> no compile cache
                sig.append((step.library, step.routine, args))
            except TypeError:
                return None
        specs = None
        if self.input_specs is not None:
            specs = tuple(sorted(
                (slot, tuple(int(d) for d in shape), str(dtype))
                for slot, (shape, dtype) in self.input_specs.items()))
        return (tuple(sig), specs)


def resolve_step_args(step: PlanStep, prior_outputs: list[dict],
                      inputs: dict[str, Any]) -> dict[str, Any]:
    """Swap a step's placeholders for real values: ``Input`` slots come
    from the engine-materialized table, ``StepRef``s from earlier steps'
    output dicts. Shared by every backend's plan interpreter."""
    kwargs = {}
    for k, v in step.args.items():
        if isinstance(v, Input):
            kwargs[k] = inputs[v.slot]
        elif isinstance(v, StepRef):
            out = prior_outputs[v.step].get(v.key)
            if out is None:
                raise BackendError(
                    f"plan step {v.step} produced no output {v.key!r} "
                    f"for {step.library}.{step.routine}")
            kwargs[k] = out
        else:
            kwargs[k] = v
    return kwargs


# ---------------------------------------------------------------------------
# shape rules for the bucketable linear kernels — shared by every backend
# so the bucketing metadata can never diverge between implementations.
# Each raises ValueError on shape combinations the routine itself would
# reject, which is what filters warmup bucket enumeration.
# ---------------------------------------------------------------------------
def shapes_multiply(shapes: dict, **_scalars) -> dict:
    a, b = shapes["A"], shapes["B"]
    if len(a) != 2 or len(b) != 2 or a[1] != b[0]:
        raise ValueError(f"multiply needs (n,k)@(k,m), got {a} @ {b}")
    return {"C": (a[0], b[1])}


def shapes_add(shapes: dict, **_scalars) -> dict:
    a, b = shapes["A"], shapes["B"]
    if tuple(a) != tuple(b):
        raise ValueError(f"add expects equal shapes, got {a} and {b}")
    return {"C": tuple(a)}


def shapes_transpose(shapes: dict, **_scalars) -> dict:
    a = shapes["A"]
    if len(a) != 2:
        raise ValueError(f"transpose expects a matrix, got {a}")
    return {"C": (a[1], a[0])}


def shapes_gram(shapes: dict, **_scalars) -> dict:
    a = shapes["A"]
    if len(a) != 2:
        raise ValueError(f"gram expects a matrix, got {a}")
    return {"G": (a[1], a[1])}


class ExecutionBackend(abc.ABC):
    """The protocol every execution environment implements.

    Subclasses populate ``_impls`` (``(library, routine) -> RoutineImpl``)
    via :meth:`register`, declare whether they can fuse
    (``supports_fusion``), and override :meth:`compile` when a multi-step
    plan can be lowered to something better than sequential
    interpretation.
    """

    #: registry name; ``AlchemistContext(backend=...)`` selects by it
    name: str = ""
    #: engine layouts this backend can produce/accept at all
    layouts: tuple[str, ...] = LAYOUTS
    #: whether the engine may hand this backend multi-step fused plans
    supports_fusion: bool = False

    def __init__(self):
        self._impls: dict[tuple[str, str], RoutineImpl] = dict(
            getattr(type(self), "_registered", {}))

    # ---- registration ---------------------------------------------------
    @classmethod
    def register(cls, library: str, routine: str, *, fusible: bool = False,
                 accepts: Optional[tuple[str, ...]] = None,
                 relayout_to: str = ROWBLOCK, bucketable: bool = False,
                 out_shapes: Optional[Callable[..., dict]] = None):
        """Class decorator-factory registering an array-level impl:
        ``@Backend.register("elemental", "gram", fusible=True)``."""
        def wrap(fn):
            reg = cls.__dict__.get("_registered")
            if reg is None:
                reg = {}
                setattr(cls, "_registered", reg)
            reg[(library, routine)] = RoutineImpl(
                fn=fn, fusible=fusible, accepts=accepts,
                relayout_to=relayout_to, bucketable=bucketable,
                out_shapes=out_shapes)
            return fn
        return wrap

    # ---- lookup ---------------------------------------------------------
    def supports(self, library: str, routine: str) -> bool:
        return (library, routine) in self._impls

    def fusible(self, library: str, routine: str) -> bool:
        impl = self._impls.get((library, routine))
        return impl is not None and impl.fusible

    def routine_impl(self, library: str, routine: str,
                     fallback: Optional[Callable] = None) -> RoutineImpl:
        """The registered implementation, or a legacy ALI wrapper around
        ``fallback`` (the library's own callable) for routines this
        backend was never taught — third-party libraries keep working."""
        impl = self._impls.get((library, routine))
        if impl is not None:
            return impl
        if fallback is not None:
            return RoutineImpl(fn=fallback, kind=ALI)
        raise BackendError(
            f"backend {self.name!r} has no implementation of "
            f"{library}.{routine} and no ALI fallback was provided")

    def routines(self) -> list[tuple[str, str]]:
        """Every (library, routine) this backend explicitly serves."""
        return sorted(self._impls)

    def capabilities(self) -> dict:
        """Discoverable backend description (tests, debugging, docs)."""
        return {
            "name": self.name,
            "layouts": list(self.layouts),
            "supports_fusion": self.supports_fusion,
            "routines": [f"{lib}.{rn}" for lib, rn in self.routines()],
        }

    # ---- arrays ---------------------------------------------------------
    @abc.abstractmethod
    def to_native(self, array) -> Any:
        """Engine-resident (device) array -> this backend's native type."""

    @abc.abstractmethod
    def is_array(self, value) -> bool:
        """True for output values the engine must mint handles for."""

    # ---- execution ------------------------------------------------------
    def compile(self, plan: ExecutionPlan) -> Callable[[dict], list[dict]]:
        """Lower a plan to a callable ``inputs -> [outputs per step]``.

        The base implementation interprets the plan sequentially with
        each step's registered ``fn`` — correct for every backend;
        subclasses override to do better (the jax backend jits the whole
        multi-step plan into one program)."""
        def run(inputs: dict) -> list[dict]:
            outs: list[dict] = []
            for step in plan.steps:
                yield_check()
                outs.append(step.impl.fn(
                    **resolve_step_args(step, outs, inputs)))
            return outs
        return run

    def release(self) -> None:
        """Drop whatever the backend holds on the device between calls
        (captured programs); the engine calls it at shutdown. Nothing by
        default."""
