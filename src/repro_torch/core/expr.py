"""The lazy client expression layer — one proxy type over the whole ACI.

The paper's ACI promises "call MPI libraries as if they were local"
(§3.1.2/§3.3.2). Before this layer the client surface leaked three value
kinds (``MatrixHandle``, ``protocol.DeferredHandle``, ``AlFuture``) and
every routine was a stringly-typed ``ac.call("elemental", "svd", ...)``
that failed engine-side, after submit. This module collapses the surface
to the shapes a native library would have:

* :class:`AlMatrix` — the one client proxy for an engine-resident matrix.
  It is either **concrete** (it holds a ``MatrixHandle``) or **deferred**
  (it names one declared output of a still-pending task). Any routine
  accepts it in either state: a deferred proxy crosses the wire as a
  ``DeferredHandle`` dependency edge, so a whole expression chain —
  including the operator sugar ``A @ B``, ``A + B``, ``A.T``, lowered to
  elemental routines — submits as one pipelined burst with **zero
  intermediate client round trips**. ``result()`` / ``to_numpy()`` /
  ``.shape`` force.
* :class:`LibraryProxy` / :class:`RoutineProxy` — ``ac.library("elemental")``
  returns a façade whose attributes are the library's routines, built from
  the engine's typed catalog (``describe`` endpoint, specs declared with
  ``core/libraries/spec.py``). Calls validate client-side — unknown
  routine, missing/unknown kwarg, wrong-session handle all fail fast with
  the catalog-derived message — and tuple-unpack by declared output order:
  ``Q, R = el.qr(A)``.
* :class:`AlFuture` — the task-level handle behind both surfaces (the old
  ``call_async`` API keeps returning it unchanged).

State machine of an :class:`AlMatrix`::

      RoutineProxy call                       force (.result()/.shape/
      ───────────────▶  DEFERRED              .to_numpy()/.handle)
                        (future, key) ───────────────────▶ CONCRETE
      ac.send_matrix /                                     (handle)
      AlMatrix.wrap   ────────────────────────────────────▶    │
                                                               │ .free()
                                                          FREED (terminal:
                                                          any use raises)

Everything here is client-side; nothing in this module touches engine
internals except through the wire protocol carried by the context.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional, Union

import numpy as np

from repro_torch.core import protocol
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import spec as specs

if TYPE_CHECKING:                     # import cycle: context imports expr
    from repro_torch.core.context import AlchemistContext
    from repro_torch.frontend.rowmatrix import RowMatrix


class AlchemistError(RuntimeError):
    pass


class AlchemistBusyError(AlchemistError):
    """Admission control denied the request: the tenant is at one of its
    QoS quotas (queue depth, in-flight upload bytes, resident handle
    memory — see ``core/qos/admission.py``). ``retry_after_s`` is the
    engine's estimate of when capacity frees; the client-side backoff
    loop in ``context._submit`` honors it before re-raising."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class AlFuture:
    """Client-side handle on one submitted task (the async half of the
    ACI). ``result()`` blocks on the engine's ``wait`` endpoint;
    ``done()``/``state()`` poll without blocking; ``fut[key]`` names one
    of the routine's output handles — a real MatrixHandle once the task
    finished, a :class:`protocol.DeferredHandle` placeholder before that,
    which later ``call_async`` invocations accept as arguments (the
    engine chains them with dependency edges, §3.3.2 pipelined).

    The façade API returns :class:`AlMatrix` proxies instead (one per
    declared output); this class remains the task-level surface both
    share. After ``ac.stop()`` an unfetched future is marked dead: every
    later use raises a clear :class:`AlchemistError` instead of the
    engine's KeyError for a dropped task-table row."""

    def __init__(self, ac: "AlchemistContext", task: int, label: str = ""):
        self.ac = ac
        self.task = task
        self.label = label
        self._result: Optional[protocol.Result] = None
        self._stop_msg: str = ""      # set by AlchemistContext.stop()

    def _check_not_orphaned(self) -> None:
        if self._stop_msg and self._result is None:
            raise AlchemistError(self._stop_msg)

    def __getitem__(self, key: str
                    ) -> Union[MatrixHandle, protocol.DeferredHandle]:
        self._check_not_orphaned()
        if self._result is None and not self.ac._stopped:
            # resolve lazily: once the producer is terminal its outputs
            # are real handles (one cheap poll; still zero round trips
            # while the task is in flight)
            poll = self.ac._task_op(protocol.POLL, self.task)
            if poll.state in ("DONE", "FAILED"):
                self._result = self.ac._task_op(protocol.WAIT, self.task)
        if self._result is not None:
            if self._result.error:
                # chaining on a producer known to have failed is a
                # client-side error — a deferred placeholder would only
                # fail later with a worse message
                raise AlchemistError(
                    f"cannot take output {key!r} of failed "
                    f"{self.label or 'task'} #{self.task}: "
                    f"{self._result.error}")
            v = self._result.values.get(key)
            if not isinstance(v, MatrixHandle):
                raise KeyError(
                    f"{self.label or 'task'} #{self.task} produced no "
                    f"handle named {key!r}")
            return v
        return protocol.DeferredHandle(task=self.task, key=key)

    def state(self) -> str:
        """Current scheduler state: QUEUED/RUNNING/DONE/FAILED. Raises
        :class:`AlchemistError` if the engine no longer knows the task
        (e.g. polled after ``ac.stop()``) — never loops as not-done."""
        self._check_not_orphaned()
        if self._result is not None:
            return self._result.state
        res = self.ac._task_op(protocol.POLL, self.task)
        if res.error:
            raise AlchemistError(res.error)
        return res.state

    def done(self) -> bool:
        return self.state() in ("DONE", "FAILED")

    def result(self) -> dict[str, Any]:
        """Block until the task completes; return its outputs plus
        ``_elapsed`` (execute seconds, legacy key), ``_wait_s`` (queued
        behind dependencies/workers), ``_exec_s``, and the cache fields
        ``_cache_hit``/``_saved_s`` (True and the avoided execute seconds
        when the engine served this from its routine cache). Raises
        :class:`AlchemistError` if the routine failed.

        Fetch before ``ac.stop()``: disconnect drops the session's
        retained task results engine-side, so an unfetched future raises
        after stop, while one fetched earlier keeps serving its client-
        side cache."""
        self._check_not_orphaned()
        if self._result is None:
            self.ac._check_alive()
            self._result = self.ac._task_op(protocol.WAIT, self.task)
        res = self._result
        if res.error:
            raise AlchemistError(res.error)
        out = dict(res.values)
        out["_elapsed"] = res.elapsed
        out["_wait_s"] = res.wait_s
        out["_exec_s"] = res.exec_s
        out["_cache_hit"] = res.cache_hit
        out["_saved_s"] = res.saved_s
        return out


class AlMatrix:
    """Client-side proxy for an engine-resident distributed matrix
    (§3.3.2) — concrete (holds the handle) or deferred (names a pending
    task's output); see the module docstring for the state machine. The
    data stays on the engine until explicitly materialized.

    The legacy dual-mode constructor is kept as a shim:
    ``AlMatrix(ac, handle)`` wraps, ``AlMatrix(ac, array_like)`` uploads
    via ``ac.send_matrix``. New code should use :meth:`wrap` /
    ``ac.send_matrix`` / the library façades directly."""

    def __init__(self, ac: "AlchemistContext", data_or_handle=None,
                 last_transfer=None):
        self.ac = ac
        self.last_transfer = last_transfer
        self._handle: Optional[MatrixHandle] = None
        self._future: Optional[AlFuture] = None
        self._key: str = ""
        self._freed = False
        if data_or_handle is None:
            return                    # wrap()/deferred() fill the state in
        if isinstance(data_or_handle, MatrixHandle):
            self._handle = data_or_handle
        else:
            al = ac.send_matrix(data_or_handle)
            self._handle = al._handle
            self.last_transfer = al.last_transfer

    # ---- constructors -----------------------------------------------------
    @classmethod
    def wrap(cls, ac: "AlchemistContext", handle: MatrixHandle,
             last_transfer=None) -> "AlMatrix":
        """Concrete proxy over an existing engine handle (e.g. a routine
        output) — the canonical replacement for the dual-mode
        constructor's handle branch."""
        m = cls(ac)
        m._handle = handle
        m.last_transfer = last_transfer
        return m

    @classmethod
    def deferred(cls, ac: "AlchemistContext", future: AlFuture,
                 key: str) -> "AlMatrix":
        """Deferred proxy over one named output of a submitted task —
        what the library façades hand back. Usable as a routine argument
        immediately (it crosses as a dependency edge)."""
        m = cls(ac)
        m._future = future
        m._key = key
        return m

    @staticmethod
    def from_handle(ac: "AlchemistContext",
                    handle: MatrixHandle) -> "AlMatrix":
        return AlMatrix.wrap(ac, handle)

    # ---- state ------------------------------------------------------------
    @property
    def is_deferred(self) -> bool:
        """True while this proxy names a not-yet-fetched task output."""
        return self._handle is None and self._future is not None

    @property
    def future(self) -> Optional[AlFuture]:
        """The producing task's future (None for uploaded/wrapped
        proxies) — carries the routine's scalar outputs and timing."""
        return self._future

    def _label(self) -> str:
        if self._handle is not None:
            return f"handle #{self._handle.id}"
        return (f"output {self._key!r} of "
                f"{self._future.label or 'task'} #{self._future.task}")

    def _check_usable(self) -> None:
        if self._freed:
            raise AlchemistError(
                f"AlMatrix ({self._label()}) was freed; it no longer "
                "names engine content")

    def __repr__(self) -> str:
        if self._freed:
            return f"<AlMatrix freed {self._label()}>"
        if self.is_deferred:
            return f"<AlMatrix deferred {self._label()}>"
        h = self._handle
        dims = "x".join(str(s) for s in h.shape)
        return f"<AlMatrix {dims} {h.dtype} handle #{h.id}>"

    # ---- forcing ----------------------------------------------------------
    def result(self) -> "AlMatrix":
        """Force: block until the producing task finished and pin the
        real handle (no-op when already concrete). Returns ``self`` so
        forcing chains: ``(A @ B).result().shape``. Raises
        :class:`AlchemistError` if the producer failed (including an
        upstream failure propagated along the chain's data edges)."""
        self._check_usable()
        if self._handle is None:
            res = self._future.result()     # raises on failure/post-stop
            v = res.get(self._key)
            if not isinstance(v, MatrixHandle):
                outs = sorted(k for k, x in res.items()
                              if isinstance(x, MatrixHandle))
                raise AlchemistError(
                    f"{self._future.label or 'task'} #{self._future.task} "
                    f"produced no handle named {self._key!r} "
                    f"(handle outputs: {outs})")
            self._handle = v
        return self

    @property
    def handle(self) -> MatrixHandle:
        """The engine handle (forces a deferred proxy)."""
        return self.result()._handle

    @property
    def shape(self) -> tuple[int, ...]:
        return self.handle.shape

    @property
    def dtype(self) -> str:
        return self.handle.dtype

    @property
    def layout(self) -> str:
        """The engine-side distributed layout this matrix was minted in
        (``rowblock`` / ``block2d`` / ``replicated``; forces a deferred
        proxy). Real as of the backend ABI: backends declare the layouts
        they accept and the engine relayouts when they disagree."""
        return self.handle.layout

    def stats(self) -> dict[str, Any]:
        """The producing routine's scalar outputs and timing (forces);
        ``{}`` for uploaded/wrapped proxies. Handles are stripped — they
        are reachable as façade outputs already."""
        self._check_usable()
        if self._future is None:
            return {}
        res = self._future.result()
        return {k: v for k, v in res.items()
                if not isinstance(v, MatrixHandle)}

    def _wire_arg(self) -> Union[MatrixHandle, protocol.DeferredHandle]:
        """What this proxy contributes to a Command's args: the concrete
        handle when known, else a ``DeferredHandle`` dependency edge —
        *without* any engine round trip, so an N-stage chain submits in
        exactly N crossings. A producer already known (client-side) to
        have failed raises immediately — fail fast beats a worse error
        later."""
        self._check_usable()
        if self._handle is not None:
            return self._handle
        fut = self._future
        fut._check_not_orphaned()
        if fut._result is not None:
            if fut._result.error:
                raise AlchemistError(
                    f"cannot chain on {self._label()}: producer failed: "
                    f"{fut._result.error}")
            return self.result()._handle
        return protocol.DeferredHandle(task=fut.task, key=self._key)

    # ---- materialization --------------------------------------------------
    def to_row_matrix(self, num_partitions: int = 8) -> "RowMatrix":
        """Materialize on the client (streams back chunk-by-chunk)."""
        return self.ac.fetch(self.handle, num_partitions)

    def to_numpy(self) -> np.ndarray:
        return self.to_row_matrix().collect()

    def free(self) -> None:
        """Release this proxy's reference on the engine (forces a
        deferred proxy first). A second ``free()`` on the same proxy
        raises instead of silently decrementing a reference this proxy
        no longer owns (which could steal e.g. the result cache's)."""
        if self._freed:
            raise AlchemistError(
                f"double free of AlMatrix ({self._label()}): this "
                "proxy's reference was already released; freeing again "
                "would decrement a reference held by another owner")
        h = self.handle
        self.ac.free(h)
        self._freed = True

    # ---- operator sugar (lowered to elemental routines) -------------------
    # keep numpy from absorbing a proxy as a 0-d object array when it
    # appears on the right of an ndarray operator: with this None, numpy
    # defers and Python raises a plain TypeError instead
    __array_ufunc__ = None

    def _elemental(self) -> "LibraryProxy":
        return self.ac.library("elemental")

    @staticmethod
    def _known_shape(m: "AlMatrix") -> Optional[tuple[int, ...]]:
        return m._handle.shape if m._handle is not None else None

    def __matmul__(self, other) -> "AlMatrix":
        if not isinstance(other, AlMatrix):
            return NotImplemented
        a, b = self._known_shape(self), self._known_shape(other)
        if a and b and a[-1] != b[0]:
            raise AlchemistError(
                f"shape mismatch for @: {a} @ {b} (inner dimensions "
                "must agree)")
        return self._elemental().multiply(A=self, B=other)

    def __add__(self, other) -> "AlMatrix":
        if not isinstance(other, AlMatrix):
            return NotImplemented
        a, b = self._known_shape(self), self._known_shape(other)
        if a is not None and b is not None and a != b:
            raise AlchemistError(f"shape mismatch for +: {a} + {b}")
        return self._elemental().add(A=self, B=other)

    @property
    def T(self) -> "AlMatrix":
        """Deferred transpose (lowered to ``elemental.transpose``)."""
        return self._elemental().transpose(A=self)


class RoutineProxy:
    """One callable routine of a library façade, bound to a typed spec.

    Calling it validates positional/keyword args against the declared
    schema **client-side** (unknown kwarg, missing required, wrong kind,
    wrong-session proxy — all before anything crosses), submits through
    the context's async path, and returns one deferred :class:`AlMatrix`
    per declared output, in declared order — ``Q, R = el.qr(A)``. A
    routine with no declared outputs returns the raw :class:`AlFuture`.
    """

    def __init__(self, ac: "AlchemistContext", library: str,
                 spec: specs.RoutineSpec):
        self._ac = ac
        self._library = library
        self.spec = spec
        self.__doc__ = spec.doc or None
        self.__name__ = spec.name

    def __repr__(self) -> str:
        return f"<routine {self._library}.{self.spec.signature()}>"

    def __call__(self, *args, **kwargs):
        label = f"{self._library}.{self.spec.name}"
        bound = self.spec.bind(args, kwargs)
        for k, v in bound.items():
            if isinstance(v, AlMatrix):
                if v.ac is not self._ac:
                    raise AlchemistError(
                        f"{label}: argument {k!r} belongs to session "
                        f"#{v.ac.session}, not this context's session "
                        f"#{self._ac.session} — handles are session-"
                        "scoped; re-send the data or share the engine-"
                        "side content instead")
        specs.validate_args(
            self.spec, bound, context=label,
            is_matrix=lambda v: isinstance(
                v, (AlMatrix, MatrixHandle, protocol.DeferredHandle)))
        wire = {k: (v._wire_arg() if isinstance(v, AlMatrix) else v)
                for k, v in bound.items()}
        fut = self._ac._submit(self._library, self.spec.name, wire)
        if not self.spec.outputs:
            return fut
        outs = tuple(AlMatrix.deferred(self._ac, fut, key)
                     for key in self.spec.outputs)
        return outs[0] if len(outs) == 1 else outs


class LibraryProxy:
    """``ac.library(name)`` — a loaded ALI library as a native-looking
    module: attributes are :class:`RoutineProxy` callables built from the
    engine's ``describe`` catalog; ``routines()``/``describe()``/
    ``dir()`` make the surface discoverable; an unknown routine raises
    with the catalog in the message."""

    def __init__(self, ac: "AlchemistContext", name: str,
                 catalog: dict[str, specs.RoutineSpec]):
        self._ac = ac
        self._name = name
        self._catalog = dict(catalog)

    @property
    def name(self) -> str:
        return self._name

    def routines(self) -> list[str]:
        """Declared routine names, sorted (the discoverable catalog)."""
        return sorted(self._catalog)

    def describe(self, routine: Optional[str] = None):
        """The typed spec of one routine, or the whole catalog dict."""
        if routine is None:
            return dict(self._catalog)
        sp = self._catalog.get(routine)
        if sp is None:
            raise KeyError(self._missing(routine))
        return sp

    def _missing(self, item: str) -> str:
        return (f"library {self._name!r} has no routine {item!r}; "
                f"catalog: {', '.join(self.routines())}")

    def __getattr__(self, item: str) -> RoutineProxy:
        if item.startswith("_"):
            raise AttributeError(item)
        sp = self._catalog.get(item)
        if sp is None:
            raise AttributeError(self._missing(item))
        return RoutineProxy(self._ac, self._name, sp)

    def __dir__(self):
        return sorted(set(super().__dir__()) | set(self._catalog))

    def __repr__(self) -> str:
        return (f"<library {self._name!r}: "
                f"{', '.join(s.signature() for s in sorted(self._catalog.values(), key=lambda s: s.name))}>")
