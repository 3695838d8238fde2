"""Client-side API — the Alchemist-Client Interface (ACI, §3.1.2/§3.3.2).

The façade surface mirrors calling a native library (the redesign the
interface paper arXiv:1806.01270 converges on):

    from repro_torch.core import AlchemistContext

    with AlchemistContext(device="cuda") as ac:
        from repro_torch.core.libraries import elemental
        ac.register_library("elemental", elemental)
        el = ac.library("elemental")        # typed catalog over the wire
        A = ac.send_matrix(a)               # streamed upload -> AlMatrix
        Q, R = el.qr(A)                     # lazy: declared output order
        G = (Q.T @ Q) + R                   # operator sugar, still lazy
        G.to_numpy()                        # force + stream back

``ac.library(name)`` fetches the engine's typed routine catalog over the
``describe`` protocol endpoint and returns a :class:`LibraryProxy`:
unknown routine, missing/unknown kwarg, and wrong-session handle all fail
**client-side**, before anything crosses the bridge, with the
catalog-derived message. Routine calls return lazy :class:`AlMatrix`
proxies (one per declared output); chains of deferred proxies compile to
engine-side dependency edges and submit as one pipelined burst with zero
intermediate round trips — ``result()``/``to_numpy()``/``.shape`` force.

Constructing a context performs the connect handshake against the engine
(§3.1.1): the engine mints a session ID that scopes every later transfer
and routine call to this client's handle namespace.
``AlchemistContext(backend="reference")`` (or :meth:`configure`) selects
the *execution backend* the session's routines run in — the torch
backend (the port's CUDA kernels on a CUDA engine) by default, the
plain-numpy reference implementation for debugging — over the
``configure`` protocol endpoint. Several contexts can
attach to one engine concurrently — the paper's multiple Spark
applications sharing one Alchemist instance — without clobbering each
other's handles. ``stop()`` (or leaving the ``with`` block) sends the
disconnect and the engine reclaims everything this session still owns;
outstanding unfetched futures are marked so later use raises a clear
:class:`AlchemistError`.

The original stringly-typed surface — ``ac.call``/``ac.call_async`` with
``fut["Q"]`` deferred outputs — keeps working unchanged as a thin shim
over the same submit path (it skips client-side validation, so errors
surface engine-side as before). Prefer the façade API in new code.
"""
from __future__ import annotations

import time
import types
import weakref
from typing import Any, Optional

from repro_torch.core import protocol, transfer, wire
from repro_torch.core.engine import ENGINE_LIBRARY, AlchemistEngine
from repro_torch.core.expr import AlchemistBusyError, AlchemistError, \
    AlFuture, AlMatrix, LibraryProxy
from repro_torch.core.handles import MatrixHandle
from repro_torch.core.libraries import spec as specs
from repro_torch.frontend.rowmatrix import RowMatrix

__all__ = ["AlchemistBusyError", "AlchemistContext", "AlchemistError",
           "AlFuture", "AlMatrix", "LibraryProxy"]

# client half of the QoS backpressure loop (`engine admission control ->
# AlchemistBusyError + retry_after_s -> this backoff`): first retry delay
# when the engine sent no hint, and the hard cap on any single sleep so a
# pessimistic engine hint cannot stall a client for seconds per attempt
_BUSY_BACKOFF_S = 0.05
_BUSY_BACKOFF_CAP_S = 2.0


class AlchemistContext:
    """One client session against an engine (one attached Spark driver).

    Multiple contexts may share an engine (the paper's concurrent Spark
    applications), each with its own engine-minted session ID, isolated
    handle namespace, and transfer accounting. ``chunk_rows`` sets the
    default row-block size for streamed transfers (None = auto-size
    chunks to ~``transfer.DEFAULT_CHUNK_BYTES``).

    ``address="host:port"`` attaches to a *remote* engine served by
    ``python -m repro_torch.core.server`` instead of an in-process one: the
    context then holds a :class:`~repro_torch.core.wire.SocketBridge` and the
    identical protocol bytes cross real TCP frames — nothing else about
    the façade changes.

    Without ``engine`` or ``address`` the context builds an in-process
    engine on ``device`` (``"cuda"`` by default; it raises where CUDA is
    absent, and only an explicit ``device="cpu"`` runs on the CPU), with
    ``num_workers`` capped at that one device.

    Usable as a context manager: ``with AlchemistContext(...) as ac:``
    calls :meth:`stop` on exit, even on error.
    """

    def __init__(self, num_workers: Optional[int] = None,
                 engine: Optional[AlchemistEngine] = None,
                 client_name: str = "", chunk_rows: Optional[int] = None,
                 backend: Optional[str] = None,
                 fusion: Optional[bool] = None,
                 bucketing: Optional[bool] = None,
                 address: Optional[str] = None,
                 busy_retries: int = 4,
                 device="cuda"):
        if address is not None:
            # remote engine: same façade, the traffic just crosses TCP
            # (core/wire.py frames to a core/server.py instance)
            if engine is not None:
                raise ValueError(
                    "pass either engine= (in-process) or address= "
                    "(socket bridge), not both")
            engine = wire.SocketBridge(address)
        elif engine is None:
            engine = AlchemistEngine(device=device, num_workers=num_workers)
        self.engine = engine
        self.chunk_rows = chunk_rows
        # QoS backpressure: how many times a busy (admission-denied)
        # submit is retried with capped exponential backoff before the
        # typed AlchemistBusyError reaches the caller; 0 = fail fast
        self.busy_retries = max(0, int(busy_retries))
        self._stopped = False
        self._futures: "weakref.WeakSet[AlFuture]" = weakref.WeakSet()
        self._library_cache: dict[str, LibraryProxy] = {}
        res = protocol.decode_result(engine.handshake(
            protocol.encode_handshake(protocol.Handshake(
                action=protocol.CONNECT, client=client_name))))
        if res.error:
            raise AlchemistError(res.error)
        self.session = res.values["session"]
        self.num_workers_granted = res.values["workers"]
        # the execution environment this session's commands run in
        # (``core/backends``); ``backend=None`` keeps the engine default
        self.backend = res.values.get("backend", "")
        if backend is not None or fusion is not None or \
                bucketing is not None:
            try:
                self.configure(backend=backend, fusion=fusion,
                               bucketing=bucketing)
            except AlchemistError:
                # leave no half-connected session behind a bad backend name
                self.stop()
                raise

    def __enter__(self) -> "AlchemistContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # ---- library registration & discovery (the typed catalog) ----
    def register_library(self, name: str, module) -> None:
        """Ask the engine to load an ALI library module (§3.1.3), through
        the wire protocol like every other client action: the module
        crosses as its import path and the engine imports it server-side,
        as a scheduler *barrier* task — so loading serializes correctly
        with every in-flight task from every session. Libraries are
        engine-global: every attached session can call them."""
        self._check_alive()
        if not isinstance(module, types.ModuleType):
            raise TypeError(
                "register_library sends the module's import path across "
                f"the wire; got {type(module).__name__} — use "
                "engine.load_library for in-process objects")
        self.call(ENGINE_LIBRARY, "load_library", name=name,
                  module=module.__name__)
        # a (re)load may change any catalog — refetch façades lazily
        self._library_cache.clear()

    def libraries(self) -> list[str]:
        """Names of the engine's loaded libraries (``describe`` over the
        wire), including the always-present ``_engine`` builtins."""
        return sorted(self._describe())

    def library(self, name: str, refresh: bool = False) -> LibraryProxy:
        """The typed façade for one loaded library: attributes are its
        routines (``Q, R = ac.library("elemental").qr(A)``), validated
        client-side against the engine's declared catalog. The catalog
        is fetched over the ``describe`` endpoint once and cached;
        ``refresh=True`` (or any ``register_library`` on this context)
        refetches."""
        if not refresh:
            cached = self._library_cache.get(name)
            if cached is not None:
                return cached
        cats = self._describe(name)
        proxy = LibraryProxy(self, name, {
            rn: specs.from_wire(d)
            for rn, d in cats[name]["routines"].items()})
        self._library_cache[name] = proxy
        return proxy

    def configure(self, backend: Optional[str] = None,
                  fusion: Optional[bool] = None,
                  bucketing: Optional[bool] = None,
                  warmup=None, cache_dir: Optional[str] = None,
                  weight: Optional[float] = None,
                  quotas: Optional[dict] = None) -> dict:
        """Select this session's execution environment over the
        ``configure`` protocol endpoint: ``backend`` names a registered
        engine backend (``"torch"`` — the accelerated default — or
        ``"reference"``, the plain-numpy debugging implementation);
        ``fusion=False`` opts the session out of chain fusion (every
        command dispatches as its own task); ``bucketing`` opts this
        session in/out of operand shape bucketing; ``warmup=True`` (or a
        list of bucket sizes) AOT-compiles the bucketable catalog and
        indexed hot signatures right now, off the request path;
        ``cache_dir`` points the engine at a directory that keeps the
        index of the signatures it serves, which a restarted engine's
        warmup rebuilds (programs themselves are not kept). On a
        QoS-enabled engine (``AlchemistEngine(qos=True)``), ``weight``
        sets this session's fair-share weight (default 1.0; a weight-2
        tenant earns twice the dispatch share) and ``quotas`` overrides
        its admission quotas (keys ``max_queue_depth``,
        ``max_inflight_bytes``, ``max_resident_bytes``; None = engine
        default). Returns — and records on ``self.backend`` — the
        effective settings; an unknown backend raises
        :class:`AlchemistError` listing what the engine offers."""
        self._check_alive()
        options: dict = {}
        if backend is not None:
            options["backend"] = backend
        if fusion is not None:
            options["fusion"] = fusion
        if bucketing is not None:
            options["bucketing"] = bucketing
        if warmup is not None:
            options["warmup"] = list(warmup) \
                if isinstance(warmup, (list, tuple)) else warmup
        if cache_dir is not None:
            options["cache_dir"] = cache_dir
        if weight is not None:
            options["weight"] = weight
        if quotas is not None:
            options["quotas"] = dict(quotas)
        res = protocol.decode_result(self.engine.configure(
            protocol.encode_configure(protocol.Configure(
                session=self.session, options=options))))
        if res.error:
            raise AlchemistError(res.error)
        self.backend = res.values["backend"]
        return res.values

    def _describe(self, library: str = "") -> dict:
        """Wire-level catalog query; returns ``values["libraries"]``."""
        self._check_alive()
        res = protocol.decode_result(self.engine.describe(
            protocol.encode_describe(protocol.Describe(
                library=library, session=self.session))))
        if res.error:
            raise AlchemistError(res.error)
        return res.values["libraries"]

    # ---- data movement (the streaming transfer layer, §3.2) ----
    def send_matrix(self, matrix, name: Optional[str] = None,
                    chunk_rows: Optional[int] = None,
                    dedup: bool = True) -> "AlMatrix":
        """Stream a client matrix to the engine in row-block chunks and
        wrap the resulting session-owned handle. With ``dedup`` (default)
        a re-upload of content the engine already holds short-circuits to
        a handle alias — zero bytes cross, and ``last_transfer.dedup``
        marks the saved crossing."""
        self._check_alive()
        handle, rec = transfer.to_engine(
            self.engine, matrix, name=name, session=self.session,
            chunk_rows=chunk_rows if chunk_rows is not None
            else self.chunk_rows, dedup=dedup)
        return AlMatrix.wrap(self, handle, last_transfer=rec)

    def fetch(self, handle: MatrixHandle, num_partitions: int = 8,
              chunk_rows: Optional[int] = None) -> RowMatrix:
        """Stream an engine matrix back as a RowMatrix (§3.3.2's
        ``toIndexedRowMatrix()``). Only handles visible to this session
        may be fetched."""
        self._check_alive()
        rm, _ = transfer.to_client(
            self.engine, handle, num_partitions, session=self.session,
            chunk_rows=chunk_rows if chunk_rows is not None
            else self.chunk_rows)
        return rm

    # ---- routine invocation (async task scheduler, §3.1.2) ----
    def call(self, library: str, routine: str, **kwargs) -> dict[str, Any]:
        """Invoke one ALI routine through the wire protocol, blocking
        until it completes (submit + wait on the engine's scheduler).
        Handle args resolve inside this session's namespace on the engine
        side; the result dict carries routine outputs plus ``_elapsed``
        (execute) / ``_wait_s`` (queued) seconds.

        Legacy shim: prefer ``ac.library(name).routine(...)``, which
        validates client-side and returns lazy AlMatrix proxies."""
        return self.call_async(library, routine, **kwargs).result()

    def call_async(self, library: str, routine: str,
                   **kwargs) -> "AlFuture":
        """Submit one ALI routine to the engine's task scheduler and
        return immediately with an :class:`AlFuture`.

        Args may be scalars, MatrixHandles, AlMatrix proxies (concrete
        *or* deferred), or the deferred outputs of earlier futures
        (``earlier["Q"]``): deferred args become dependency edges
        engine-side, so a whole chain can be submitted in one burst and
        pipelines without further round trips.

        If the engine's content-addressed routine cache already holds this
        exact computation, the future comes back *already completed*
        (DONE-on-submit): no task is minted, ``result()`` returns without
        blocking, and ``_cache_hit``/``_saved_s`` report the skip.

        Legacy shim: the façade path (``ac.library(...)``) submits
        through the same machinery but validates args client-side first.
        """
        self._check_alive()
        args = {k: self._as_arg(v) for k, v in kwargs.items()}
        return self._submit(library, routine, args)

    def _submit(self, library: str, routine: str,
                args: dict[str, Any]) -> "AlFuture":
        """Encode + submit one command (args already wire-shaped); shared
        by the legacy ``call_async`` and the façade RoutineProxy path.

        A busy engine (QoS admission denial, ``AlchemistBusyError`` over
        the wire) is retried up to ``busy_retries`` times with capped
        exponential backoff, honoring the engine's ``retry_after_s`` hint
        when it sends one; exhaustion raises the typed
        :class:`AlchemistBusyError` carrying the last hint."""
        self._check_alive()
        payload = protocol.encode_command(protocol.Command(
            library=library, routine=routine, args=args,
            session=self.session))
        delay = _BUSY_BACKOFF_S
        for attempt in range(self.busy_retries + 1):
            sub = protocol.decode_result(self.engine.submit(payload))
            if not (sub.error
                    and sub.error.startswith("AlchemistBusyError")):
                break
            if attempt == self.busy_retries:
                break
            hint = sub.retry_after_s
            time.sleep(min(hint if hint > 0 else delay,
                           _BUSY_BACKOFF_CAP_S))
            delay = min(delay * 2, _BUSY_BACKOFF_CAP_S)
        if sub.error:
            if sub.error.startswith("AlchemistBusyError"):
                _, _, msg = sub.error.partition(": ")
                raise AlchemistBusyError(msg or sub.error,
                                         retry_after_s=sub.retry_after_s)
            raise AlchemistError(sub.error)
        fut = AlFuture(self, sub.task, label=f"{library}.{routine}")
        if sub.cache_hit:
            fut._result = sub           # served at submit; nothing to wait
        self._futures.add(fut)
        return fut

    @staticmethod
    def _as_arg(v):
        if isinstance(v, AlMatrix):
            # concrete -> its handle; deferred -> a DeferredHandle edge
            # (no round trip); freed/known-failed -> raises here
            return v._wire_arg()
        if isinstance(v, AlFuture):
            raise TypeError(
                "pass a future's named output (fut['Q']), not the future "
                "itself — routines produce several handles")
        return v

    def wrap(self, handle: MatrixHandle) -> "AlMatrix":
        """Wrap an engine handle (e.g. a routine output) as an AlMatrix."""
        return AlMatrix.wrap(self, handle)

    def free(self, handle: MatrixHandle) -> None:
        """Release one reference to a session-visible handle."""
        self._check_alive()
        self.engine.free(handle, session=self.session)

    def stop(self) -> None:
        """Disconnect: the engine reclaims every handle this session still
        owns (the paper's driver detach). Idempotent.

        Outstanding *unfetched* futures — and the deferred AlMatrix
        proxies backed by them — are marked dead: any later use raises
        :class:`AlchemistError` explaining the session dropped its task
        results at disconnect, instead of the engine's KeyError for an
        unknown task. Futures fetched before stop keep serving their
        client-side cached results."""
        if self._stopped:
            return
        self._stopped = True
        for fut in list(self._futures):
            if fut._result is None:
                fut._stop_msg = (
                    f"AlchemistContext (session #{self.session}) was "
                    f"stopped before task #{fut.task} "
                    f"({fut.label or 'routine'}) was fetched; the engine "
                    "drops a session's retained task results at "
                    "disconnect — call result() before stop()")
        wire_bytes = protocol.encode_handshake(protocol.Handshake(
            action=protocol.DISCONNECT, session=self.session))
        if isinstance(self.engine, wire.SocketBridge):
            # this context owns its connection (connection-per-session):
            # after the disconnect nothing else will cross — hang up. A
            # server that already went away amounts to the same teardown
            # (it reclaims the session on its side), so stop() stays
            # idempotent instead of raising into client cleanup code.
            try:
                self.engine.handshake(wire_bytes)
            except (wire.WireError, OSError):
                pass
            self.engine.close()
        else:
            self.engine.handshake(wire_bytes)

    def _check_alive(self):
        if self._stopped:
            raise AlchemistError("AlchemistContext is stopped")

    def _task_op(self, action: str, task: int) -> protocol.Result:
        res = protocol.decode_result(self.engine.task_op(
            protocol.encode_task_op(protocol.TaskOp(
                action=action, task=task, session=self.session))))
        return res
