"""Typed ALI routine specs — the catalog half of the ACI redesign.

The paper pitches the ACI as calling MPI libraries *as if they were
local* (§3.1.2/§3.3.2), but a stringly-typed ``ac.call("elemental",
"svd", ...)`` only discovers a typo'd routine name or a wrong kwarg
engine-side, after the command has crossed the bridge. The Alchemist
interface paper (arXiv:1806.01270) and the Dask/PySpark follow-up
(arXiv:1910.01354) converge on the fix: the client surface must look
like a native library with *declared*, discoverable signatures.

This module is that declaration layer:

* :func:`routine` — decorator applied to every ALI routine, declaring the
  *ordered output names* (what tuple-unpacks client-side: ``Q, R =
  el.qr(A)``) plus optional ``writes``/``nocache`` scheduler/cache
  attributes. Parameter names, kinds, and defaults are read off the
  function signature itself: the first parameter is the engine view (the
  ALI calling convention), annotated ``int``/``float``/``str``/``bool``
  parameters are scalars, and un-annotated parameters are engine-resident
  matrices (handles).
* :class:`RoutineSpec`/:class:`ParamSpec` — the frozen schema objects.
* :func:`catalog` / :func:`to_wire` / :func:`from_wire` — what the engine
  builds at ``load_library`` time and serves over the ``describe``
  protocol endpoint, so any client can rebuild the typed catalog from
  plain msgpack values.
* :meth:`RoutineSpec.bind` / :func:`validate_args` — the client-side
  fail-fast path: unknown kwarg, missing required arg, and
  wrong-kind values raise :class:`SpecError` (a ``TypeError``) with the
  catalog-derived signature in the message, before anything crosses.

A routine that never used the decorator still catalogs (``declared=False``,
no output order) — discoverability degrades gracefully instead of
refusing third-party libraries.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np

MATRIX = "matrix"      # an engine-resident handle (AlMatrix client-side)

# annotation -> declared scalar kind
_ANNOTATION_KINDS = {int: "int", float: "float", str: "str", bool: "bool",
                     "int": "int", "float": "float", "str": "str",
                     "bool": "bool"}

# kind -> runtime acceptance predicate (client-side validation).
# bool is excluded from int/float on purpose: True silently becoming 1
# is exactly the class of bug fail-fast validation exists to catch.
_KIND_OK: dict[str, Callable[[Any], bool]] = {
    "int": lambda v: isinstance(v, (int, np.integer))
    and not isinstance(v, bool),
    "float": lambda v: isinstance(v, (int, float, np.integer, np.floating))
    and not isinstance(v, bool),
    "str": lambda v: isinstance(v, str),
    "bool": lambda v: isinstance(v, bool),
    "any": lambda v: True,
}


class SpecError(TypeError):
    """A call that violates a routine's declared signature — raised
    client-side, before the command is encoded or submitted."""


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One declared parameter: ``kind`` is ``"matrix"`` (an engine handle)
    or a scalar kind (``int``/``float``/``str``/``bool``/``any``)."""
    name: str
    kind: str
    required: bool
    default: Any = None


@dataclasses.dataclass(frozen=True)
class RoutineSpec:
    """The declared schema of one ALI routine.

    ``outputs`` is the *ordered* tuple of handle-valued output names —
    the contract behind client-side tuple unpacking. ``declared=False``
    marks a spec synthesized by introspection from an undecorated
    routine (params are still known; output order is not).
    """
    name: str
    params: tuple[ParamSpec, ...] = ()
    outputs: tuple[str, ...] = ()
    doc: str = ""
    writes: tuple[str, ...] = ()
    nocache: bool = False
    declared: bool = True

    def param(self, name: str) -> Optional[ParamSpec]:
        for p in self.params:
            if p.name == name:
                return p
        return None

    def signature(self) -> str:
        """Human signature for error messages and ``help()``-style
        discovery: ``qr(A) -> (Q, R)``."""
        parts = []
        for p in self.params:
            if p.required:
                parts.append(p.name if p.kind == MATRIX
                             else f"{p.name}: {p.kind}")
            else:
                parts.append(f"{p.name}: {p.kind}={p.default!r}")
        out = ", ".join(self.outputs) if self.outputs else "..."
        return f"{self.name}({', '.join(parts)}) -> ({out})"

    def bind(self, args: tuple, kwargs: dict) -> dict[str, Any]:
        """Map positional + keyword call args onto declared parameter
        names (the client-side analogue of Python's own binding).
        Raises :class:`SpecError` naming the declared signature on too
        many positionals, an unknown kwarg, a duplicate, or a missing
        required parameter."""
        if len(args) > len(self.params):
            raise SpecError(
                f"{self.name}() takes at most {len(self.params)} "
                f"argument(s) ({len(args)} given) — declared: "
                f"{self.signature()}")
        bound = {p.name: v for p, v in zip(self.params, args)}
        for k, v in kwargs.items():
            if self.param(k) is None:
                known = ", ".join(p.name for p in self.params) or "none"
                raise SpecError(
                    f"{self.name}() got an unexpected keyword argument "
                    f"{k!r} (declared parameters: {known}) — declared: "
                    f"{self.signature()}")
            if k in bound:
                raise SpecError(
                    f"{self.name}() got multiple values for argument "
                    f"{k!r} — declared: {self.signature()}")
            bound[k] = v
        missing = [p.name for p in self.params
                   if p.required and p.name not in bound]
        if missing:
            raise SpecError(
                f"{self.name}() missing required argument(s) "
                f"{missing} — declared: {self.signature()}")
        return bound


def _introspect(fn: Callable, name: str, outputs: tuple[str, ...] = (),
                writes: tuple[str, ...] = (), nocache: bool = False,
                declared: bool = True) -> RoutineSpec:
    """Derive a spec from a routine's signature: skip the leading engine
    view, map annotations to scalar kinds, treat un-annotated params as
    matrices (the ALI convention throughout the bundled libraries)."""
    params = []
    sig = inspect.signature(fn)
    for i, p in enumerate(sig.parameters.values()):
        if i == 0:      # the engine/SessionView argument — not client-facing
            continue
        if p.annotation is inspect.Parameter.empty:
            kind = MATRIX
        else:
            kind = _ANNOTATION_KINDS.get(p.annotation, "any")
        required = p.default is inspect.Parameter.empty
        params.append(ParamSpec(
            name=p.name, kind=kind, required=required,
            default=None if required else p.default))
    doc = (inspect.getdoc(fn) or "").split("\n\n")[0].strip()
    return RoutineSpec(name=name, params=tuple(params),
                       outputs=tuple(outputs), doc=doc,
                       writes=tuple(writes), nocache=bool(nocache),
                       declared=declared)


def routine(*, outputs: tuple[str, ...] = (),
            writes: tuple[str, ...] = (), nocache: bool = False):
    """Declare an ALI routine's schema.

    ``outputs`` is the ordered names of the handle-valued outputs in the
    routine's Result dict (``("Q", "R")`` for ``qr``); the order is the
    client-side tuple-unpack contract. ``writes`` names parameters the
    routine mutates (scheduler write hazards); ``nocache`` opts out of
    result memoization. The decorated function gains a ``spec``
    attribute plus the ``writes``/``nocache`` attributes the engine's
    scheduler and cache already consult."""
    def wrap(fn):
        fn.spec = _introspect(fn, fn.__name__, outputs=tuple(outputs),
                              writes=tuple(writes), nocache=nocache)
        fn.writes = tuple(writes)
        fn.nocache = bool(nocache)
        return fn
    return wrap


def spec_only(library: str, name: str) -> NotImplementedError:
    """The error a catalog-only routine body raises if invoked directly.

    As of the backend ABI (``core/backends``) the bundled libraries
    declare *what* each routine computes — signature, outputs, doc — and
    every *how* lives in per-backend implementation registries; the
    engine builds an execution plan and dispatches it through the
    session's backend, never calling the library function. A direct call
    reaching one of these bodies is therefore a bug, and says so."""
    return NotImplementedError(
        f"{library}.{name} is a catalog declaration; its implementations "
        "are registered per-backend in repro.core.backends — dispatch "
        "through the engine (AlchemistContext.library(...)) instead of "
        "calling the library function directly")


def spec_of(fn: Callable, name: Optional[str] = None) -> RoutineSpec:
    """The routine's declared spec, or one synthesized by introspection
    (``declared=False``, no output order) for undecorated functions."""
    declared = getattr(fn, "spec", None)
    if isinstance(declared, RoutineSpec):
        if name is None or declared.name == name:
            return declared
        return dataclasses.replace(declared, name=name)
    return _introspect(fn, name or fn.__name__,
                       writes=tuple(getattr(fn, "writes", ()) or ()),
                       nocache=bool(getattr(fn, "nocache", False)),
                       declared=False)


def validate_args(spec: RoutineSpec, bound: dict[str, Any],
                  is_matrix: Optional[Callable[[Any], bool]] = None,
                  context: str = "") -> None:
    """Check already-bound args against the declared kinds, raising
    :class:`SpecError` with the catalog-derived signature on mismatch.
    ``is_matrix`` decides what counts as a matrix argument (the client
    passes a predicate accepting AlMatrix/MatrixHandle/DeferredHandle);
    scalar kinds check against Python/numpy scalar types."""
    label = context or spec.name
    for k, v in bound.items():
        p = spec.param(k)
        if p is None:       # bind() already rejected unknowns
            continue
        if p.kind == MATRIX:
            if is_matrix is not None and not is_matrix(v):
                raise SpecError(
                    f"{label}: parameter {k!r} expects an engine-resident "
                    f"matrix (AlMatrix / MatrixHandle), got "
                    f"{type(v).__name__} — raw arrays must cross the "
                    "transfer layer first (ac.send_matrix) — declared: "
                    f"{spec.signature()}")
        elif not _KIND_OK.get(p.kind, _KIND_OK["any"])(v):
            raise SpecError(
                f"{label}: parameter {k!r} expects {p.kind}, got "
                f"{type(v).__name__} ({v!r}) — declared: "
                f"{spec.signature()}")


def catalog(routines: dict[str, Callable]) -> dict[str, RoutineSpec]:
    """Specs for a library's ROUTINES dict — what the engine builds at
    ``load_library`` time."""
    return {name: spec_of(fn, name) for name, fn in routines.items()}


def to_wire(spec: RoutineSpec) -> dict:
    """Flatten a spec into msgpack-able plain values (the ``describe``
    payload)."""
    return {
        "name": spec.name,
        "params": [[p.name, p.kind, p.required, p.default]
                   for p in spec.params],
        "outputs": list(spec.outputs),
        "doc": spec.doc,
        "writes": list(spec.writes),
        "nocache": spec.nocache,
        "declared": spec.declared,
    }


def from_wire(d: dict) -> RoutineSpec:
    """Inverse of :func:`to_wire` — how the client rebuilds the typed
    catalog from a ``describe`` Result."""
    return RoutineSpec(
        name=d["name"],
        params=tuple(ParamSpec(name=n, kind=k, required=bool(r), default=v)
                     for n, k, r, v in d.get("params", ())),
        outputs=tuple(d.get("outputs", ())),
        doc=d.get("doc", ""),
        writes=tuple(d.get("writes", ())),
        nocache=bool(d.get("nocache", False)),
        declared=bool(d.get("declared", True)),
    )


def catalog_to_wire(routines: dict[str, Callable]) -> dict[str, dict]:
    """``catalog`` + ``to_wire`` in one step (what the engine stores)."""
    return {name: to_wire(s) for name, s in catalog(routines).items()}
