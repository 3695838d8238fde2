"""The Alchemist engine: the high-performance side of the bridge (§3.1.1).

The engine owns

* a *device* — in the PyTorch port one ``torch.device``, the stand-in
  for the MPI processes hosting Elemental: every store lives there, with
  an explicit layout tag per store computed by the JAX package's
  divisibility rules at one worker (rows over the worker axis when they
  divide evenly, replicated otherwise), so handle layouts and relayout
  counts equal the reference engine's at ``num_workers=1``. Library
  routines run on it, driven through the protocol layer so only
  serializable values cross;
* a *session table* — the paper's multiple Spark drivers attached to one
  Alchemist instance concurrently (§3.1.1: "Alchemist can serve several
  Spark applications at a time"). Each ``connect`` handshake mints a
  ``Session`` with its own handle namespace;
* a *task scheduler* (``core/scheduler.py``) — commands become QUEUED/
  RUNNING/DONE/FAILED tasks on a worker pool: different sessions' routines
  run concurrently, while per-session program order, per-handle read/write
  hazards, and deferred-output data dependencies are enforced as
  dependency edges. ``run`` (submit+wait) keeps the blocking call
  semantics; ``submit``/``task_op`` expose the async path;
* a *handle lifecycle layer* — session-owned handle *bindings* over
  refcounted *stores* (the arrays themselves), under an optional engine
  memory budget with LRU spill-to-host eviction and transparent reload on
  next use (the engine-side answer to the paper's observation that matrices
  must stay resident across chained calls, §3.3.2, without unbounded
  growth), plus ``free_session`` reclaiming everything a disconnected
  client left behind. Two bindings may alias one store — how dedup'd
  uploads and cross-session cache hits share content without copying;
* a *content-addressed cache* (``core/cache.py``) — every store carries a
  fingerprint (content hash for streamed uploads, derived hash for
  memoized routine outputs); a submitted command whose
  (library, routine, params, input fingerprints) key was already computed
  returns its cached output handles instantly (DONE-on-submit fast path,
  guarded against in-flight writers), and a re-upload of resident content
  short-circuits to a handle alias. ``cache_log`` carries the per-session
  hit/miss/bytes-saved accounting;
* an *execution layer* behind the pluggable **Backend ABI**
  (``core/backends``) — the engine never calls a library function
  directly: each command becomes an execution *plan* compiled through
  the session's selected backend (``configure`` endpoint; ``torch`` by
  default, plain-numpy ``reference`` for debugging). The engine owns
  handle→array materialization, **layout negotiation** (an operand in a
  layout the backend implementation does not accept gets an explicit
  relayout, counted in ``task_log``), and minting every output handle
  through the distributed-layout put path — so no routine can return
  a host-materialized array that silently drops the engine layout. When
  a worker picks up the head of a dependency chain submitted in one
  burst and the session's backend fuses, the engine *claims* the whole
  fusible chain from the scheduler and runs it as one program (the JAX
  package's jax backend does; the port's torch backend does not fuse
  yet, so its chains run step by step).

The engine runs on the device it is given: ``"cuda"`` by default, which
raises where CUDA is absent — only an explicit ``device="cpu"`` runs it
on the CPU. ``num_workers`` is accepted and capped at the one device,
as the JAX engine caps its mesh at the devices it has (§3.1.1:
Alchemist launched on "a user-specified number of nodes"). The torch
backend never fuses, so every step runs eagerly, and the engine waits
for the device (``torch.cuda.synchronize``) before it stamps a step's
seconds: CUDA launches return before the work is done.

Stores are never mutated in place: copy-on-write overwrite and
cross-session cache aliases rely on a store's tensor staying what it
was, as JAX's immutable arrays guaranteed.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import itertools
import threading
import time
from typing import Any, Optional

import torch

from repro_torch.analysis import locktrace, statemachine
from repro_torch.core import backends as backend_registry
from repro_torch.core import cache as caching, compilecache, configopts, \
    protocol, scheduler as scheduling
from repro_torch.core.backends import base as backend_base
from repro_torch.core.costmodel import CacheLog, CompileLog, QosLog, TaskLog, \
    TransferLog, routine_price_seconds
from repro_torch.core.qos import QUOTA_KEYS, AdmissionController, \
    FairShareQueue, QuotaConfig
from repro_torch.core.handles import LAYOUTS, REPLICATED, ROWBLOCK, \
    MatrixHandle
from repro_torch.core.libraries import spec as specs
from repro_torch.interop import dtype_name, host_to_tensor

SYSTEM_SESSION = 0

# Reserved library name for engine-internal routines reachable over the
# wire (library loading); real ALI libraries cannot shadow it.
ENGINE_LIBRARY = "_engine"


def engine_device(device="cuda") -> torch.device:
    """The engine's device. ``"cuda"`` (the default everywhere) raises
    when CUDA is absent; the engine never falls back to the CPU — only an
    explicit ``"cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"AlchemistEngine(device={str(device)!r}): CUDA is not "
            "available here; pass device='cpu' to run the engine on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported engine device {dev}")
    return dev


class LibraryNotRegistered(KeyError):
    pass


class UnknownSession(KeyError):
    pass


@dataclasses.dataclass
class Session:
    """Per-client engine state (§3.1.1: one attached Spark driver).

    ``owned`` is the session's handle namespace: the IDs of every
    engine-resident matrix this client created (by transfer or as routine
    output). Protocol-level handle resolution is confined to this set plus
    the system namespace, so concurrent clients cannot read or free each
    other's matrices.
    """
    id: int
    client: str = ""
    owned: set[int] = dataclasses.field(default_factory=set)
    connected_at: float = dataclasses.field(default_factory=time.time)
    commands: int = 0
    # execution configuration (the ``configure`` endpoint): which
    # registered backend runs this session's commands ("" = the engine
    # default), whether its burst-submitted chains may fuse, and whether
    # its operands may be padded to the engine's bucket grid (None =
    # follow the engine default)
    backend: str = ""
    fusion: bool = True
    bucketing: Optional[bool] = None
    # QoS fair-share weight (``configure(weight=...)``): this tenant's
    # proportional claim on the worker pool when the engine runs with
    # ``qos=True``. Meaningless (and left at 1.0) otherwise.
    weight: float = 1.0
    # Teardown flag, flipped under the engine state lock as disconnect's
    # first act. ``submit``/``reserve_upload`` re-check it under the same
    # lock before committing new work, so nothing slips in between the
    # drain observing an empty table and the session being popped.
    draining: bool = False


@dataclasses.dataclass
class _Store:
    """One engine-resident matrix (the storage half of a handle).

    ``array`` is the live device tensor, or None while spilled (then
    ``host`` holds the row-major host copy, a CPU tensor). ``refs``
    counts the *bindings* (handles) referencing this storage — aliases
    minted by transfer dedup or cross-session cache hits share one store;
    it is reclaimed when the last binding goes. ``last_use`` is the engine's logical clock value at
    the most recent touch (LRU order). ``fingerprint`` is the store's
    content address (see ``core/cache.py`` for the ``v:``/``c:``/``r:``
    namespaces); it changes on every overwrite, which is what makes
    fingerprint-derived cache keys self-invalidating."""
    array: Optional[torch.Tensor]
    nbytes: int
    shape: tuple
    dtype: str
    fingerprint: str
    refs: int = 1
    last_use: int = 0
    host: Optional[torch.Tensor] = None
    # the store's authoritative distributed layout (handles carry a
    # snapshot; overwrite can change it): one of handles.LAYOUTS
    layout: str = REPLICATED


@dataclasses.dataclass
class _Entry:
    """One handle *binding*: the session-owned name of a store.

    ``refs`` is the handle refcount (``put``/``alias`` = 1, ``retain`` /
    ``free``); the binding is reclaimed at zero, dropping one store
    reference. The content-addressed cache takes a reference on every
    output handle it memoizes, so a client ``free`` cannot invalidate a
    live cache entry — forced reclaim (``free_session``) can, and then
    the cache entry is invalidated rather than left dangling."""
    store: int
    session: int
    refs: int = 1


class SessionView:
    """What a library routine sees as its "engine" (the ALI calling
    convention, §3.1.3): handle operations scoped to the issuing session's
    namespace, everything else delegated to the engine.

    Routines keep the ``fn(engine, **args)`` signature; dispatching through
    a view is how they "resolve handles through the session" — a handle
    owned by another client raises KeyError, which ``run`` surfaces to that
    client as an error Result.
    """

    def __init__(self, engine: "AlchemistEngine", session: Session):
        self._engine = engine
        self._session = session

    @property
    def session(self) -> Session:
        return self._session

    def put(self, array: torch.Tensor, name: Optional[str] = None
            ) -> MatrixHandle:
        return self._engine.put(array, name=name, session=self._session.id)

    def get(self, handle: MatrixHandle) -> torch.Tensor:
        return self._engine.get(handle, session=self._session.id)

    def overwrite(self, handle: MatrixHandle, array: torch.Tensor) -> None:
        self._engine.overwrite(handle, array, session=self._session.id)

    def free(self, handle: MatrixHandle) -> None:
        self._engine.free(handle, session=self._session.id)

    def __getattr__(self, item):
        return getattr(self._engine, item)


class AlchemistEngine:
    """Server side: session table + handle lifecycle + library registry +
    hazard-aware concurrent routine dispatch (§3.1.1).

    ``memory_budget_bytes`` bounds device-resident matrix bytes; when a put
    or reload would exceed it, least-recently-used entries spill to host
    and transparently reload on next use. ``None`` disables eviction.
    ``scheduler_workers`` sizes the dispatch worker pool: different
    sessions' commands run concurrently up to this width (1 reproduces the
    old strictly-serialized dispatch). ``backend`` names the default
    execution backend for sessions that never ``configure`` one;
    ``fuse_chains=False`` disables chain claiming engine-wide (every
    command dispatches as its own task — the pre-ABI behaviour).

    ``device`` is where every store lives and every routine runs
    (``"cuda"`` by default; see :func:`engine_device`); ``num_workers``
    is capped at that one device.

    Compile-latency subsystem (``core/compilecache.py``):
    ``compile_cache_dir`` is refused in this slice of the port (the torch
    backend compiles nothing); ``bucketing``/``bucket_grid``
    set the engine-default shape-bucket policy (sessions override via
    ``configure``); ``warmup_on_load`` AOT-compiles the bucketable
    catalog (and every indexed hot signature) in the background whenever
    a library loads; ``warmup_grid`` is the bucket subset catalog warmup
    covers; ``program_cache_size`` bounds each backend's in-process
    compiled-program LRU. ``compile_log`` is the accounting surface.

    Multi-tenant QoS (``core/qos``): ``qos=True`` switches dispatch to
    weighted fair share and turns on admission control; ``qos_quotas``
    sets the engine-wide per-tenant quota defaults (keys:
    ``max_queue_depth``, ``max_inflight_bytes``, ``max_resident_bytes``);
    ``qos_yield_threshold_s`` is the virtual-time gap at which a long
    iterative task cooperatively yields to a starved tenant.
    ``qos_log`` is the accounting surface (see :meth:`qos_stats`).
    """

    def __init__(self, device="cuda", num_workers: Optional[int] = None,
                 transfer_log: Optional[TransferLog] = None,
                 memory_budget_bytes: Optional[int] = None,
                 scheduler_workers: int = 4,
                 cache_entries: int = 256,
                 backend: str = backend_registry.DEFAULT_BACKEND,
                 fuse_chains: bool = True,
                 compile_cache_dir: Optional[str] = None,
                 bucketing: bool = True,
                 bucket_grid=None,
                 warmup_on_load: bool = False,
                 warmup_grid=None,
                 program_cache_size: Optional[int] = None,
                 qos: bool = False,
                 qos_quotas: Optional[dict] = None,
                 qos_yield_threshold_s: float = 0.05):
        self.device = engine_device(device)
        # one device: a request for more workers is capped, as the JAX
        # engine caps its mesh at the devices it has
        self.num_workers = 1
        self.memory_budget_bytes = memory_budget_bytes
        # the pluggable execution layer: per-engine backend instances
        # (compile caches must not leak across engines)
        self.backends = backend_registry.create_backends()
        if backend not in self.backends:
            raise backend_registry.BackendError(
                f"unknown execution backend {backend!r} (available: "
                f"{', '.join(sorted(self.backends))})")
        self.default_backend = backend
        self.fuse_chains = fuse_chains
        # task id -> execution accounting (fused op count, relayouts);
        # written by workers under the state lock, drained by
        # _record_task at completion
        self._task_meta: dict[int, dict] = {}
        self._entries: dict[int, _Entry] = {}
        self._stores: dict[int, _Store] = {}
        self._store_ids = itertools.count(1)
        self._by_fingerprint: dict[str, int] = {}
        self._libraries: dict[str, dict[str, Any]] = {}
        # wire-ready typed catalogs (library -> routine -> spec dict),
        # rebuilt at load_library time and served by ``describe``; the
        # engine builtins are always discoverable
        self._catalogs: dict[str, dict[str, dict]] = {
            ENGINE_LIBRARY: specs.catalog_to_wire(self._BUILTINS)}
        # client<->engine crossings per wire endpoint — what the chain-
        # pipelining benchmark counts to prove a lazy chain submits with
        # zero intermediate round trips
        self.endpoint_counts: collections.Counter = collections.Counter()
        self.transfer_log = transfer_log or TransferLog(
            engine_procs=self.num_workers)
        self.task_log = TaskLog()
        # the content-addressed routine cache (0 entries disables
        # memoization; the transfer-dedup fingerprint index stays on —
        # it costs nothing and only ever avoids crossings)
        self.cache = caching.RoutineCache(cache_entries) \
            if cache_entries else None
        self.cache_log = CacheLog()
        # ---- compile-latency subsystem (core/compilecache.py) ----
        self.bucket_policy = compilecache.BucketPolicy(
            grid=tuple(bucket_grid) if bucket_grid is not None
            else compilecache.DEFAULT_BUCKET_GRID,
            enabled=bool(bucketing))
        self.warmup_grid = tuple(warmup_grid) if warmup_grid is not None \
            else compilecache.DEFAULT_WARMUP_GRID
        self.warmup_on_load = bool(warmup_on_load)
        self.compile_log = CompileLog()
        self.compile_cache_dir: Optional[str] = None
        self._exec_index: Optional[compilecache.ExecutableIndex] = None
        self._warmup_threads: list[threading.Thread] = []
        if program_cache_size is not None:
            for be in self.backends.values():
                if hasattr(be, "max_programs"):
                    be.max_programs = int(program_cache_size)
        if compile_cache_dir:
            self._set_cache_dir(compile_cache_dir)
        # Session 0 is the always-present system namespace: in-process
        # callers (engine-side services, the trainer) that bypass the
        # protocol operate in it.
        self._sessions: dict[int, Session] = {
            SYSTEM_SESSION: Session(id=SYSTEM_SESSION, client="system")}
        self._session_ids = itertools.count(1)
        self._clock = itertools.count(1)
        self._state_lock = locktrace.make_rlock("engine.state")
        # Lifecycle monitor (repro.analysis.statemachine): bound once at
        # construction, no-op unless REPRO_STM_TRACE=1. Keys are
        # domain-qualified with this engine's identity so concurrent
        # engines in one test process never collide.
        self._stm = statemachine.tracer()
        self._stm_dom = id(self)
        if self._stm.enabled:
            self._stm.mint("session", (self._stm_dom, SYSTEM_SESSION),
                           site="__init__")
        # ---- multi-tenant QoS (core/qos) ----
        # Default OFF: a plain engine keeps the scheduler's FIFO dispatch
        # bit-for-bit (FifoReadyQueue) and admits everything. With
        # qos=True the ready queue becomes weighted fair share, submits
        # and uploads pass admission control (``qos_quotas`` sets the
        # engine-wide per-tenant defaults; sessions override via
        # ``configure(quotas=...)``), and long iterative routines yield
        # cooperatively at iteration boundaries.
        self.qos_enabled = bool(qos)
        self.qos_log = QosLog()
        self.admission: Optional[AdmissionController] = None
        self._qos_policy: Optional[FairShareQueue] = None
        if qos_quotas is not None and not self.qos_enabled:
            raise ValueError(
                "qos_quotas requires qos=True (quotas on a QoS-disabled "
                "engine would silently never be enforced)")
        if self.qos_enabled:
            defaults = QuotaConfig(**self._validate_quotas(qos_quotas or {}))
            self.admission = AdmissionController(defaults=defaults,
                                                 log=self.qos_log)
            self._qos_policy = FairShareQueue(
                log=self.qos_log,
                yield_threshold_s=float(qos_yield_threshold_s))
        self.scheduler = scheduling.TaskScheduler(
            num_workers=scheduler_workers, on_finish=self._record_task,
            policy=self._qos_policy)
        self.scheduler._stm_domain = self._stm_dom

    # ---- session lifecycle (the connect/disconnect handshake, §3.1.1) ----
    def connect(self, client: str = "") -> Session:
        """Mint a new client session with an empty handle namespace."""
        with self._state_lock:
            sess = Session(id=next(self._session_ids), client=client)
            self._sessions[sess.id] = sess
            if self._stm.enabled:
                self._stm.mint("session", (self._stm_dom, sess.id),
                               site="connect")
                self._stm.mint("reservation", (self._stm_dom, sess.id),
                               site="connect",
                               scope=(self._stm_dom, sess.id))
            return sess

    def disconnect(self, session: int) -> None:
        """Tear down a session: drain its in-flight tasks (teardown must
        not race a routine still resolving this namespace), reclaim its
        handles and retained task results, forget it. Unfetched futures
        of a stopped context are therefore gone — fetch before stop.

        Two-phase: the session is first marked ``draining`` under the
        state lock, *then* drained. ``submit`` re-validates under the
        same lock before minting a task, so a submission racing this
        teardown either lands before the drain (and is waited for) or is
        rejected — it can no longer slip into the table after
        ``wait_session`` observed it empty and execute against a freed
        namespace."""
        with self._state_lock:
            sess = self._sessions.get(session)
            if sess is None:
                return                      # already gone: idempotent
            if not sess.draining:
                sess.draining = True
                if self._stm.enabled and session != SYSTEM_SESSION:
                    self._stm.note("session", (self._stm_dom, session),
                                   "DRAINING", site="disconnect")
        self.scheduler.wait_session(session)
        popped = False
        with self._state_lock:
            self.free_session(session)
            if session != SYSTEM_SESSION:
                popped = self._sessions.pop(session, None) is not None
            if popped and self._stm.enabled:
                # reservation first: the session's terminal transition
                # runs the cross-machine scope checks, and by then the
                # reserved-bytes row must already be declared released
                self._stm.note("reservation", (self._stm_dom, session),
                               "RELEASED", site="disconnect")
                self._stm.note("session", (self._stm_dom, session),
                               "FORGOTTEN", site="disconnect")
        self.scheduler.forget_session(session)
        if self.admission is not None:
            # a client that vanished while throttled must not leak its
            # reserved upload bytes or its quota override
            self.admission.forget_session(session)

    def free_session(self, session: int) -> int:
        """Reclaim every handle binding a session owns (regardless of
        refcount — the client is gone). Stores aliased by other sessions
        survive; cache entries whose outputs died here are invalidated.
        Returns the number of bindings dropped."""
        with self._state_lock:
            sess = self._sessions.get(session)
            if sess is None:
                return 0
            dropped = 0
            for hid in list(sess.owned):
                if hid in self._entries:
                    self._drop_binding(hid)
                    dropped += 1
            sess.owned.clear()
            return dropped

    def sessions(self) -> list[Session]:
        return [self._sessions[k] for k in sorted(self._sessions)]

    def session(self, session_id: int) -> Session:
        sess = self._sessions.get(session_id)
        if sess is None:
            raise UnknownSession(
                f"session #{session_id} is not connected to this engine")
        return sess

    def shutdown(self) -> None:
        """Tear the engine down: stop the scheduler's worker threads
        (in-flight tasks finish, queued ones fail) and drop every
        resident matrix. After this the engine accepts no more commands;
        construct a new one to continue. Idempotent."""
        self.wait_warmup()
        self.scheduler.shutdown()
        with self._state_lock:
            self._task_meta.clear()
            if self.cache is not None:
                self.cache.clear()
            for sid in list(self._sessions):
                sess = self._sessions[sid]
                sess.owned.clear()
                if sid != SYSTEM_SESSION:
                    del self._sessions[sid]
                    if self._stm.enabled:
                        self._stm.note("session", (self._stm_dom, sid),
                                       "FORGOTTEN", site="shutdown")
            if self._stm.enabled:
                for store_id in self._stores:
                    self._stm.note("store", (self._stm_dom, store_id),
                                   "RECLAIMED", site="shutdown")
            self._entries.clear()
            self._stores.clear()
            self._by_fingerprint.clear()

    def handshake(self, wire: bytes) -> bytes:
        """Protocol endpoint for connect/disconnect. Returns an encoded
        Result: on connect, ``values`` carries the fresh session ID and the
        worker count (the paper's driver handing back its resource grant)."""
        with self._state_lock:
            self.endpoint_counts["handshake"] += 1
        try:
            hs = protocol.decode_handshake(wire)
            if hs.action == protocol.CONNECT:
                sess = self.connect(hs.client)
                return protocol.encode_result(protocol.Result(
                    values={"session": sess.id, "workers": self.num_workers,
                            "backend": self.default_backend},
                    session=sess.id))
            if hs.action != protocol.DISCONNECT:
                raise ValueError(f"unknown handshake action {hs.action!r}")
            if hs.session == SYSTEM_SESSION:
                raise ValueError("the system session cannot disconnect")
            self.session(hs.session)            # raises if unknown
            self.disconnect(hs.session)
            return protocol.encode_result(protocol.Result(
                values={"session": hs.session}, session=hs.session))
        except Exception as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}"))

    # ---- library registry (the ALI layer, §3.1.3) ----
    def load_library(self, name: str, module) -> None:
        """``module`` must export ROUTINES: dict[str, callable]. Mirrors
        dynamically dlopen()ing an ALI shared object (§3.1.3). This is the
        trusted in-process path; wire clients go through the
        ``_engine.load_library`` builtin (a scheduler barrier, so loading
        serializes with every in-flight task).

        (Re)registration invalidates every cached result of this
        library's routines: cache keys hash the library *name*, not its
        code, so a reloaded implementation must never be answered with
        the old one's memoized outputs."""
        if name == ENGINE_LIBRARY:
            raise ValueError(
                f"library name {ENGINE_LIBRARY!r} is reserved for engine "
                "builtins")
        routines = getattr(module, "ROUTINES", None)
        if not isinstance(routines, dict):
            raise TypeError(f"library {name!r} exports no ROUTINES dict")
        with self._state_lock:
            self._libraries[name] = routines
            # (re)build the typed catalog the describe endpoint serves:
            # decorated routines carry their declared spec, undecorated
            # ones catalog by introspection (declared=False)
            self._catalogs[name] = specs.catalog_to_wire(routines)
            if self.cache is not None:
                for entry in self.cache.invalidate_library(name):
                    self.cache_log.record(entry.session, entry.label,
                                          "invalidate")
                    self._release_entry_outputs(entry)
        if self.warmup_on_load:
            # AOT-compile the (possibly grown) bucketable catalog and
            # every indexed hot signature off-thread — by the time a
            # tenant submits a bucketed shape, the executable exists
            self._start_warmup()

    def libraries(self) -> list[str]:
        return sorted(self._libraries)

    def describe(self, wire: bytes) -> bytes:
        """Protocol endpoint for catalog discovery: reply with the typed
        routine schemas of one library (``Describe.library``) or of every
        loaded library plus the engine builtins. The schemas are what
        ``load_library`` built from the routines' ``@routine``
        declarations — clients rebuild them with ``spec.from_wire`` and
        validate calls before anything else crosses the bridge."""
        with self._state_lock:
            self.endpoint_counts["describe"] += 1
        try:
            d = protocol.decode_describe(wire)
            if d.session == SYSTEM_SESSION:
                # same wire discipline as submit: the system namespace
                # is the trusted in-process principal, not a client
                raise ValueError(
                    "discovery cannot run in the system session; "
                    "connect() a session first")
            self.session(d.session)             # raises if unknown
            with self._state_lock:
                cats = {n: dict(c) for n, c in self._catalogs.items()}
            if d.library:
                if d.library not in cats:
                    raise LibraryNotRegistered(
                        f"library {d.library!r} not registered (loaded: "
                        f"{sorted(n for n in cats if n != ENGINE_LIBRARY)})")
                cats = {d.library: cats[d.library]}
            return protocol.encode_result(protocol.Result(
                values={"libraries": {n: {"routines": c}
                                      for n, c in cats.items()}},
                session=d.session))
        except Exception as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}"))

    # ---- session configuration (backend selection, §3.1.1 resource grant) ----
    def configure(self, wire: bytes) -> bytes:
        """Protocol endpoint for session configuration: select the
        execution backend this session's commands run in (validated
        against the registry), toggle chain fusion or shape
        ``bucketing``, point the engine at a persistent compile
        ``cache_dir``, and/or trigger an AOT ``warmup`` pass (True =
        default bucket grid; a list of ints = that grid) — the warmup
        runs synchronously here, at configure time, which is exactly the
        off-request-path moment the compile latency belongs in. Replies
        with the *effective* settings; unknown option keys are an error
        — a typo must not silently configure nothing."""
        with self._state_lock:
            self.endpoint_counts["configure"] += 1
        try:
            cfg = protocol.decode_configure(wire)
            if cfg.session == SYSTEM_SESSION:
                raise ValueError(
                    "the system session cannot be configured; connect() "
                    "a session first")
            sess = self.session(cfg.session)     # raises if unknown
            unknown = sorted(set(cfg.options) - configopts.SUPPORTED)
            if unknown:
                raise ValueError(
                    f"unknown configure option(s) {unknown}; supported: "
                    f"{', '.join(sorted(configopts.SUPPORTED))}")
            # validate every option BEFORE mutating anything: a request
            # that errors must not half-apply (the client treats an
            # error reply as "nothing changed")
            if "backend" in cfg.options:
                name = cfg.options["backend"]
                if name not in self.backends:
                    raise backend_registry.BackendError(
                        f"unknown execution backend {name!r} "
                        f"(available: {', '.join(sorted(self.backends))})")
            if "fusion" in cfg.options and \
                    not isinstance(cfg.options["fusion"], bool):
                raise TypeError("configure option 'fusion' must be a bool")
            if "bucketing" in cfg.options and \
                    not isinstance(cfg.options["bucketing"], bool):
                raise TypeError(
                    "configure option 'bucketing' must be a bool")
            warmup_grid = None
            if "warmup" in cfg.options:
                w = cfg.options["warmup"]
                if isinstance(w, (list, tuple)):
                    if not w or not all(
                            isinstance(b, int) and not isinstance(b, bool)
                            and b > 0 for b in w):
                        raise TypeError(
                            "configure option 'warmup' as a list must "
                            "hold positive bucket sizes")
                    warmup_grid = tuple(w)
                elif not isinstance(w, bool):
                    raise TypeError(
                        "configure option 'warmup' must be a bool or a "
                        "list of bucket sizes")
            if "cache_dir" in cfg.options and \
                    not isinstance(cfg.options["cache_dir"], str):
                raise TypeError(
                    "configure option 'cache_dir' must be a str path")
            quotas = None
            if any(o in cfg.options for o in configopts.QOS_OPTIONS):
                if not self.qos_enabled:
                    raise ValueError(
                        "QoS is disabled on this engine; construct it "
                        "with AlchemistEngine(qos=True) before "
                        "configuring weight or quotas")
            if "weight" in cfg.options:
                w = cfg.options["weight"]
                if isinstance(w, bool) or not isinstance(w, (int, float)) \
                        or not w > 0:
                    raise TypeError(
                        "configure option 'weight' must be a positive "
                        "number")
            if "quotas" in cfg.options:
                quotas = self._validate_quotas(cfg.options["quotas"])
            with self._state_lock:
                if "backend" in cfg.options:
                    sess.backend = cfg.options["backend"]
                if "fusion" in cfg.options:
                    sess.fusion = cfg.options["fusion"]
                if "bucketing" in cfg.options:
                    sess.bucketing = cfg.options["bucketing"]
                if "cache_dir" in cfg.options:
                    # engine-wide by nature (the JAX disk cache is a
                    # process-global config) — documented, not hidden
                    self._set_cache_dir(cfg.options["cache_dir"])
                if "weight" in cfg.options:
                    sess.weight = float(cfg.options["weight"])
                effective = {
                    "session": sess.id,
                    "backend": sess.backend or self.default_backend,
                    "fusion": sess.fusion,
                    "bucketing": sess.bucketing
                    if sess.bucketing is not None
                    else self.bucket_policy.enabled,
                    "cache_dir": self.compile_cache_dir or "",
                }
            if "weight" in cfg.options:
                # rank order: scheduler.cv (20) nests fine above the
                # state lock, but there is no reason to hold it here
                self.scheduler.set_weight(sess.id, sess.weight)
            if quotas is not None:
                self.admission.set_quota(sess.id, quotas)
            if self.qos_enabled:
                q = self.admission.quota_for(sess.id)
                effective["weight"] = sess.weight
                effective["quotas"] = dataclasses.asdict(q)
            if cfg.options.get("warmup"):
                effective["warmup"] = self.warmup(
                    backend=effective["backend"], grid=warmup_grid,
                    session=sess.id)
            return protocol.encode_result(protocol.Result(
                values=effective, session=cfg.session))
        except Exception as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}"))

    def _session_backend(self, sess: Session) -> backend_base.ExecutionBackend:
        return self.backends[sess.backend or self.default_backend]

    def _backend_name(self, session_id: int) -> str:
        sess = self._sessions.get(session_id)
        if sess is None or not sess.backend:
            return self.default_backend
        return sess.backend

    # ---- compile-latency subsystem (shape buckets + AOT + persistence) ----
    def _set_cache_dir(self, cache_dir: str) -> None:
        """A persistent compile cache is not in this slice of the port:
        the torch backend compiles nothing it could persist."""
        raise NotImplementedError(
            f"compile_cache_dir={cache_dir!r}: a persistent compile cache "
            "is not in this slice of the PyTorch port")

    def _session_policy(self, sess: Optional[Session]
                        ) -> compilecache.BucketPolicy:
        """The bucket policy effective for one session (its override, or
        the engine default)."""
        if sess is None or sess.bucketing is None or \
                sess.bucketing == self.bucket_policy.enabled:
            return self.bucket_policy
        return dataclasses.replace(self.bucket_policy,
                                   enabled=sess.bucketing)

    def _prepare_program(self, backend: backend_base.ExecutionBackend,
                         plan: backend_base.ExecutionPlan,
                         inputs: dict[str, Any], sess: Session
                         ) -> tuple[Any, dict[str, Any],
                                    Optional[list[dict[str, tuple]]]]:
        """Compile front-end shared by the fused-chain and bucketed
        single-step paths: decide bucket eligibility, zero-pad operands
        up to the session's bucket grid, stamp the plan's ``input_specs``
        (so the program is AOT-compiled and shape-keyed), compile through
        the backend's instrumented path, and account every
        compile/hit/evict in ``compile_log``. Returns ``(program,
        run_inputs, crops)`` where ``crops`` is the per-step
        logical-output-shape list to crop padded results back with
        (``None`` = nothing padded, outputs land as produced)."""
        if not hasattr(backend, "get_or_compile"):
            return backend.compile(plan), inputs, None
        policy = self._session_policy(sess)
        run_inputs = inputs
        crops: Optional[list[dict[str, tuple]]] = None
        bucketed = False
        if policy.enabled and hasattr(backend, "pad_to") and \
                compilecache.plan_bucketable(plan):
            logical = {s: tuple(a.shape) for s, a in inputs.items()}
            padded = {s: policy.bucket_shape(sh)
                      for s, sh in logical.items()}
            crops = compilecache.propagate_shapes(plan, logical)
            if crops is not None and compilecache.propagate_shapes(
                    plan, padded) is not None:
                # pad/crop stay OUTSIDE the compiled program: inside the
                # trace they would bake the logical shapes into the key,
                # defeating the bucket collapse
                run_inputs = {s: backend.pad_to(a, padded[s])
                              for s, a in inputs.items()}
                bucketed = True
            else:
                crops = None    # rule rejected: run exact, real error
        plan.input_specs = {s: (tuple(a.shape), str(a.dtype))
                            for s, a in run_inputs.items()}
        program, info = backend.get_or_compile(plan)
        self._account_compile(backend, plan, info,
                              session=sess.id if sess else SYSTEM_SESSION,
                              bucketed=bucketed, on_request_path=True)
        return program, run_inputs, crops

    def _crop_outputs(self, backend: backend_base.ExecutionBackend,
                      outs_list: list[dict],
                      crops: list[dict[str, tuple]]) -> list[dict]:
        """Slice every padded program output back to its logical shape
        (per the plan's propagated shape rules)."""
        cropped = []
        for outs, shapes in zip(outs_list, crops):
            cropped.append({
                k: backend.crop_to(v, shapes[k])
                if k in shapes and backend.is_array(v) else v
                for k, v in outs.items()})
        return cropped

    def _account_compile(self, backend: backend_base.ExecutionBackend,
                         plan: backend_base.ExecutionPlan, info: dict,
                         session: int, bucketed: bool,
                         on_request_path: bool) -> None:
        """Record one program lookup in ``compile_log`` and — for fresh
        AOT compiles — in the executable index (how hot signatures
        register themselves for the next warmup)."""
        label = compilecache.plan_label(plan)
        if info["cached"]:
            self.compile_log.record(session, label, "hit",
                                    on_request_path=on_request_path,
                                    bucketed=bucketed,
                                    steps=len(plan.steps))
        else:
            self.compile_log.record(session, label, "compile",
                                    on_request_path=on_request_path,
                                    aot=info["aot"], bucketed=bucketed,
                                    steps=len(plan.steps),
                                    compile_s=info["compile_s"])
            if self._exec_index is not None and info["aot"]:
                self._exec_index.record(backend.name, plan,
                                        info["compile_s"])
        if info.get("evicted"):
            self.compile_log.record(session, label, "evict",
                                    on_request_path=on_request_path,
                                    count=info["evicted"])

    def warmup(self, backend: Optional[str] = None, grid=None,
               session: int = -1) -> dict:
        """AOT-compile the programs tenant traffic will ask for, off the
        request path: (1) every hot signature in the executable index
        (plans compiled by any earlier run against this cache dir — the
        re-lower hits JAX's disk cache, so a warm restart replays
        without recompiling); (2) every bucketable fusible cataloged
        routine at each valid combination of the warmup bucket grid.
        Returns counts; every compile lands in ``compile_log`` with
        ``on_request_path=False``."""
        name = backend or self.default_backend
        be = self.backends.get(name)
        stats = {"backend": name, "catalog": 0, "replayed": 0,
                 "compiled": 0, "cached": 0, "warmup_s": 0.0,
                 "skipped": False, "reason": ""}
        if be is None or not getattr(be, "supports_aot", False):
            # explicit no-op, not a silent one: the reference backend
            # (and any other eager backend) has no AOT surface to warm,
            # and the caller deserves to know nothing was compiled
            # rather than inferring it from zero counts
            stats["skipped"] = True
            stats["reason"] = (
                f"backend {name!r} is not registered" if be is None else
                f"backend {name!r} has no AOT compile surface; "
                "warmup is a no-op")
            return stats
        t_start = time.perf_counter()
        grid_t = tuple(int(g) for g in (grid or self.warmup_grid))

        def compile_plan(plan, bucketed):
            program, info = be.get_or_compile(plan)
            stats["cached" if info["cached"] else "compiled"] += 1
            self._account_compile(be, plan, info, session=session,
                                  bucketed=bucketed,
                                  on_request_path=False)

        # replay the index FIRST — previously-served signatures are
        # known-hot (real traffic), and replaying before the catalog
        # phase keeps "replayed" from counting combos the catalog pass
        # itself just recorded
        if self._exec_index is not None:
            for rec in self._exec_index.entries(backend=name):
                plan = compilecache.plan_from_record(rec, be)
                if plan is None:
                    continue          # routine no longer registered
                stats["replayed"] += 1
                compile_plan(plan, bucketed=False)
        for lib, rn in be.routines():
            impl = be.routine_impl(lib, rn)
            if not (impl.kind == backend_base.ARRAY and impl.fusible
                    and impl.bucketable and impl.out_shapes is not None):
                continue
            params = compilecache.matrix_params_of(impl)
            for combo in compilecache.warmup_shape_sets(
                    impl, params, grid_t):
                slots: dict[str, tuple] = {}
                args: dict[str, Any] = {}
                for k in params:
                    slot = f"i{len(slots)}"
                    slots[slot] = combo[k]
                    args[k] = backend_base.Input(slot)
                plan = backend_base.ExecutionPlan(
                    steps=[backend_base.PlanStep(
                        library=lib, routine=rn, args=args, impl=impl)],
                    input_specs={s: (tuple(sh), "float32")
                                 for s, sh in slots.items()})
                stats["catalog"] += 1
                compile_plan(plan, bucketed=True)
        stats["warmup_s"] = time.perf_counter() - t_start
        return stats

    def _start_warmup(self) -> None:
        """Kick a background warmup (the ``warmup_on_load`` path): the
        load_library reply returns immediately while the catalog
        compiles off-thread; ``wait_warmup`` joins."""
        t = threading.Thread(target=self._warmup_quiet, daemon=True,
                             name="alchemist-warmup")
        with self._state_lock:
            self._warmup_threads.append(t)
        t.start()

    def _warmup_quiet(self) -> None:
        try:
            self.warmup()
        except Exception:
            pass        # warmup is an optimization; never fail a load

    def wait_warmup(self) -> None:
        """Block until every background warmup kicked so far finished."""
        with self._state_lock:
            threads = list(self._warmup_threads)
        for t in threads:
            t.join()
        with self._state_lock:
            self._warmup_threads = [t for t in self._warmup_threads
                                    if t.is_alive()]

    def compile_stats(self) -> dict:
        """Engine-wide compile accounting: the CompileLog summary plus
        each backend's live program-cache occupancy/evictions and the
        executable-index size — what benchmarks and session stats
        surface."""
        out = self.compile_log.stats()
        out["executable_index"] = len(self._exec_index) \
            if self._exec_index is not None else 0
        out["program_caches"] = {
            n: be.program_cache_info()
            for n, be in self.backends.items()
            if hasattr(be, "program_cache_info")}
        out["active_backend"] = self.default_backend
        return out

    # ---- multi-tenant QoS (core/qos) ----
    @staticmethod
    def _validate_quotas(quotas: dict) -> dict:
        """Validate a quota dict (ctor ``qos_quotas`` or a
        ``configure(quotas=...)`` override): known keys only, values
        ``None`` (disable that check) or a non-negative int."""
        if not isinstance(quotas, dict):
            raise TypeError("quotas must be a dict of quota knobs")
        unknown = sorted(set(quotas) - set(QUOTA_KEYS))
        if unknown:
            raise ValueError(
                f"unknown quota knob(s) {unknown}; supported: "
                f"{', '.join(QUOTA_KEYS)}")
        out = {}
        for k, v in quotas.items():
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 0):
                raise TypeError(
                    f"quota knob {k!r} must be None or a non-negative "
                    f"int, got {v!r}")
            out[k] = v
        return out

    def _task_price(self, cmd: protocol.Command) -> float:
        """Fair-share price estimate for a command: the cost model's
        routine price over the bytes of its resident handle args.
        Computed at submit time on the endpoint thread (NOT under the
        scheduler lock — the policy only reads the stamped value)."""
        nbytes = 0
        with self._state_lock:
            def walk(v):
                nonlocal nbytes
                if isinstance(v, MatrixHandle):
                    entry = self._entries.get(v.id)
                    if entry is not None:
                        nbytes += self._stores[entry.store].nbytes
                elif isinstance(v, dict):
                    for x in v.values():
                        walk(x)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        walk(x)
            for v in cmd.args.values():
                walk(v)
        return routine_price_seconds(cmd.library, cmd.routine, nbytes)

    def _session_resident_bytes(self, session: int) -> int:
        """Store bytes owned by one session's bindings (each shared
        store counted once) — the resident-memory quota input."""
        with self._state_lock:
            sess = self._sessions.get(session)
            if sess is None:
                return 0
            seen: set[int] = set()
            total = 0
            for hid in sess.owned:
                entry = self._entries.get(hid)
                if entry is not None and entry.store not in seen:
                    seen.add(entry.store)
                    total += self._stores[entry.store].nbytes
            return total

    def _session_weight(self, session: int) -> float:
        sess = self._sessions.get(session)
        return sess.weight if sess is not None else 1.0

    def reserve_upload(self, session: int, nbytes: int
                       ) -> Optional[tuple[str, float]]:
        """Data-plane backpressure: reserve in-flight upload bytes for a
        staged transfer (the server calls this at UPLOAD_BEGIN). None =
        reserved; ``(reason, retry_after_s)`` = the tenant is over its
        in-flight quota and nothing was reserved. Always None with QoS
        off."""
        if self.admission is None:
            return None
        denial = self.admission.reserve_upload(
            session, nbytes, weight=self._session_weight(session))
        if denial is not None:
            return denial
        # The reservation itself can race disconnect: admission says yes,
        # then teardown's forget_session() wipes the row — and this late
        # reservation would re-create it and leak its bytes forever
        # (nothing will ever commit or abort the stream of a gone
        # client). Re-check liveness under the state lock — disconnect
        # marks the session draining under the same lock before it
        # reclaims anything — and compensate by releasing what was just
        # reserved (a release on an already-forgotten row is a clamped
        # no-op, so both orderings of the race end with zero held bytes).
        with self._state_lock:
            sess = self._sessions.get(session)
            live = sess is not None and not sess.draining
            if live and self._stm.enabled:
                self._stm.note("reservation", (self._stm_dom, session),
                               "ACTIVE", site="reserve_upload")
        if not live:
            self.admission.release_upload(session, nbytes)
            return (f"session #{session} is disconnecting", 0.0)
        return None

    def release_upload(self, session: int, nbytes: int) -> None:
        """Release an upload reservation (commit, abort, teardown)."""
        if self.admission is not None:
            self.admission.release_upload(session, nbytes)
            if self._stm.enabled:
                with self._state_lock:
                    # skip once disconnect declared the row RELEASED —
                    # this release is then the upload path returning
                    # bytes forget_session() already reclaimed
                    if session in self._sessions:
                        left = self.admission.inflight_bytes(session)
                        self._stm.note(
                            "reservation", (self._stm_dom, session),
                            "ACTIVE" if left > 0 else "IDLE",
                            site="release_upload")

    def _qos_yield(self, session: int) -> None:
        """Iteration-boundary hook body installed on worker threads
        (``backends.base.set_yield_check``): when the fair-share queue
        says another tenant trails this one's virtual time, briefly
        release the host (the sleep drops the GIL, letting a light
        tenant's worker run) and account the preemption."""
        if self._qos_policy is None:
            return
        if self.scheduler.should_yield(session):
            self.qos_log.record(session=session, event="preempted",
                                weight=self._session_weight(session))
            time.sleep(0.002)

    def qos_stats(self) -> dict:
        """Engine-wide QoS accounting: admitted/rejected/throttled/
        preempted counters, fair-share debt, p50/p99 wait split by
        weight class (``costmodel.QosLog``), plus live ready-queue
        depths per session under fair share."""
        out = self.qos_log.stats()
        out["enabled"] = self.qos_enabled
        if self._qos_policy is not None:
            out["ready_depths"] = self.scheduler.ready_depths()
        return out

    # ---- handle lifecycle (bindings over refcounted stores) ----
    def _on_device(self, array) -> torch.Tensor:
        """``array`` as a tensor on the engine device: host arrays under
        the JAX package's dtype rules (``interop.host_to_tensor``)."""
        if isinstance(array, torch.Tensor):
            return array.to(self.device)
        return host_to_tensor(array, self.device)

    def put(self, array, name: Optional[str] = None,
            session: int = SYSTEM_SESSION,
            fingerprint: Optional[str] = None,
            layout: Optional[str] = None) -> MatrixHandle:
        """Register a tensor (moved to the engine device; a host array is
        converted under the JAX package's dtype rules) under a fresh
        handle owned by ``session`` (refcount 1), evicting LRU stores if
        over budget.

        ``fingerprint`` content-addresses the store (the transfer layer
        passes the chunk-hash combination so later uploads of equal bytes
        can alias instead of crossing); ``None`` mints an opaque version
        — correct, just never dedup'd. ``layout`` is the store's layout
        tag: the transfer layer and routine outputs pass the engine's
        distributed layout (:meth:`dist_layout`), tests simulating a
        foreign distribution pass another; ``None`` tags a bare tensor
        ``replicated``, as the JAX engine tags an array that carries no
        distributed sharding."""
        array = self._on_device(array)
        with self._state_lock:
            sess = self.session(session)
            lay = layout if layout is not None else REPLICATED
            if lay not in LAYOUTS:
                raise ValueError(f"unknown layout {lay!r} "
                                 f"(one of {LAYOUTS})")
            handle = MatrixHandle.fresh(array.shape, dtype_name(array.dtype),
                                        layout=lay, name=name)
            nbytes = array.numel() * array.element_size()
            fp = fingerprint or f"v:{next(self._clock)}"
            store_id = next(self._store_ids)
            self._stores[store_id] = _Store(
                array=array, nbytes=nbytes, shape=tuple(array.shape),
                dtype=dtype_name(array.dtype), fingerprint=fp,
                last_use=next(self._clock),
                layout=lay)
            self._by_fingerprint.setdefault(fp, store_id)
            if self._stm.enabled:
                self._stm.mint("store", (self._stm_dom, store_id),
                               site="put")
            self._entries[handle.id] = _Entry(store=store_id,
                                              session=session)
            sess.owned.add(handle.id)
            self._enforce_budget(keep=store_id)
            return handle

    def get(self, handle: MatrixHandle, session: Optional[int] = None
            ) -> torch.Tensor:
        """Resolve a handle to its device tensor, transparently reloading a
        spilled store. ``session=None`` is the trusted in-process path
        (global lookup); a session ID confines resolution to that
        namespace plus the system one (protocol-level isolation)."""
        with self._state_lock:
            entry = self._visible_entry(handle, session)
            store = self._stores[entry.store]
            store.last_use = next(self._clock)
            if store.array is None:                     # spilled -> reload
                store.array = store.host.to(self.device)
                store.host = None
                if self._stm.enabled:
                    self._stm.note("store", (self._stm_dom, entry.store),
                                   "LIVE", site="get")
                self._enforce_budget(keep=entry.store)
            return store.array

    def overwrite(self, handle: MatrixHandle, array,
                  session: Optional[int] = None) -> None:
        """Replace the matrix a handle names, in place (same ID, same
        owner, refcount untouched) — the engine-side *write* path that
        read/write hazard tracking orders against. Only the owning
        session (or the trusted in-process path) may write a handle; the
        new array must keep the handle's shape/dtype so every outstanding
        copy of the handle stays truthful.

        A store shared with aliases (dedup'd uploads, cross-session cache
        hits) is copied-on-write: the aliases keep the old content, only
        this binding sees the new array. Either way the binding ends up
        on a fresh fingerprint and every cache entry touching this handle
        is invalidated — an overwritten result must never be served.
        The new content is tagged ``replicated``, as :meth:`put` tags a
        bare tensor."""
        array = self._on_device(array)
        with self._state_lock:
            entry = self._visible_entry(handle, session)
            if session is not None and entry.session != session:
                raise KeyError(
                    f"handle #{handle.id} is owned by session "
                    f"#{entry.session}; session #{session} may read "
                    "but not overwrite it")
            if tuple(array.shape) != tuple(handle.shape) or \
                    dtype_name(array.dtype) != str(handle.dtype):
                raise ValueError(
                    f"overwrite of handle #{handle.id} must keep shape "
                    f"{handle.shape} and dtype {handle.dtype}, got "
                    f"{tuple(array.shape)}/{dtype_name(array.dtype)}")
            store = self._stores[entry.store]
            fp = f"v:{next(self._clock)}"
            lay = REPLICATED
            if store.refs > 1:                          # copy-on-write
                store.refs -= 1
                store_id = next(self._store_ids)
                self._stores[store_id] = _Store(
                    array=array, nbytes=store.nbytes,
                    shape=tuple(array.shape), dtype=dtype_name(array.dtype),
                    fingerprint=fp, last_use=next(self._clock),
                    layout=lay)
                if self._stm.enabled:
                    self._stm.mint("store", (self._stm_dom, store_id),
                                   site="overwrite")
                entry.store = store_id
                self._enforce_budget(keep=store_id)
            else:
                if self._by_fingerprint.get(store.fingerprint) == \
                        entry.store:
                    del self._by_fingerprint[store.fingerprint]
                was_spilled = store.array is None
                store.fingerprint = fp
                store.array = array
                store.host = None
                if was_spilled and self._stm.enabled:
                    self._stm.note("store", (self._stm_dom, entry.store),
                                   "LIVE", site="overwrite")
                store.layout = lay
                store.last_use = next(self._clock)
                self._enforce_budget(keep=entry.store)
            self._by_fingerprint.setdefault(fp, entry.store)
            self._cache_invalidate(handle.id, outputs_only=False)

    def free(self, handle: MatrixHandle,
             session: Optional[int] = None) -> None:
        """Drop one reference; the binding is reclaimed at refcount zero
        (and its store with it, unless aliases remain).

        A session may only free handles it *owns*: system-namespace
        matrices are readable by every session (shared inputs) but
        releasable only by the trusted in-process path (``session=None``)
        — otherwise one protocol client could destroy another principal's
        state."""
        with self._state_lock:
            if handle.id not in self._entries:
                return                       # double-free is a no-op
            entry = self._visible_entry(handle, session)
            if session is not None and entry.session != session:
                raise KeyError(
                    f"handle #{handle.id} is owned by session "
                    f"#{entry.session}; session #{session} may read "
                    "but not free it")
            entry.refs -= 1
            if entry.refs <= 0:
                self._drop_binding(handle.id)

    def retain(self, handle: MatrixHandle) -> None:
        """Take an extra reference (e.g. a handle shared across calls)."""
        with self._state_lock:
            self._entry(handle).refs += 1

    def refcount(self, handle: MatrixHandle) -> int:
        with self._state_lock:
            entry = self._entries.get(handle.id)
            return 0 if entry is None else entry.refs

    def fingerprint(self, handle: MatrixHandle) -> str:
        """The content fingerprint of the store a handle names."""
        with self._state_lock:
            return self._stores[self._entry(handle).store].fingerprint

    def alias_by_fingerprint(self, fingerprint: str, shape, session: int,
                             name: Optional[str] = None
                             ) -> Optional[MatrixHandle]:
        """Mint a new handle in ``session`` aliasing the resident store
        whose content fingerprint matches, or return None. The transfer
        layer's dedup path: a re-upload of already-resident content
        becomes a namespace entry instead of a crossing."""
        with self._state_lock:
            store_id = self._by_fingerprint.get(fingerprint)
            if store_id is None:
                return None
            store = self._stores.get(store_id)
            if store is None or store.shape != tuple(
                    int(s) for s in shape):
                return None
            return self._alias_store(store_id, session, name=name)

    def is_spilled(self, handle: MatrixHandle) -> bool:
        """True if the matrix currently lives on host (LRU-evicted)."""
        with self._state_lock:
            entry = self._entries.get(handle.id)
            if entry is None:
                return False
            return self._stores[entry.store].array is None

    def resident_bytes(self) -> int:
        """Bytes of matrix data currently on engine devices."""
        with self._state_lock:
            return sum(s.nbytes for s in self._stores.values()
                       if s.array is not None)

    def spilled_bytes(self) -> int:
        """Bytes of matrix data currently spilled to host."""
        with self._state_lock:
            return sum(s.nbytes for s in self._stores.values()
                       if s.array is None)

    def _entry(self, handle: MatrixHandle) -> _Entry:
        entry = self._entries.get(handle.id)
        if entry is None:
            raise KeyError(f"handle #{handle.id} is not resident "
                           "on this engine (already freed?)")
        return entry

    def _visible_entry(self, handle: MatrixHandle,
                       session: Optional[int]) -> _Entry:
        entry = self._entry(handle)
        if session is not None and entry.session not in (
                session, SYSTEM_SESSION):
            raise KeyError(
                f"handle #{handle.id} is not visible in session "
                f"#{session} (owned by session #{entry.session})")
        return entry

    def _alias_store(self, store_id: int, session: int,
                     name: Optional[str] = None) -> MatrixHandle:
        """New binding in ``session`` over an existing store (one more
        store reference; the alias has its own handle refcount)."""
        store = self._stores[store_id]
        sess = self.session(session)
        handle = MatrixHandle.fresh(store.shape, store.dtype,
                                    layout=store.layout, name=name)
        store.refs += 1
        self._entries[handle.id] = _Entry(store=store_id, session=session)
        sess.owned.add(handle.id)
        return handle

    def _drop_binding(self, handle_id: int) -> None:
        """Reclaim one binding unconditionally: detach it from its owner
        and store (reclaiming the store at zero references), then
        invalidate any cache entry whose outputs named this handle — its
        cached values would otherwise dangle."""
        entry = self._entries.pop(handle_id)
        owner = self._sessions.get(entry.session)
        if owner is not None:
            owner.owned.discard(handle_id)
        store = self._stores.get(entry.store)
        if store is not None:
            store.refs -= 1
            if store.refs <= 0:
                if self._stm.enabled:
                    self._stm.note("store", (self._stm_dom, entry.store),
                                   "RECLAIMED", site="_drop_binding")
                del self._stores[entry.store]
                if self._by_fingerprint.get(store.fingerprint) == \
                        entry.store:
                    del self._by_fingerprint[store.fingerprint]
        self._cache_invalidate(handle_id, outputs_only=True)

    def _enforce_budget(self, keep: Optional[int] = None) -> None:
        """Spill LRU device-resident stores to host until under budget.
        ``keep`` pins one store (the one being put/reloaded right now).
        Spill never touches refcounts or the cache: a spilled store
        reloads transparently on next use, so memoized results that point
        at it stay valid."""
        if self.memory_budget_bytes is None:
            return
        resident = [(s.last_use, sid, s) for sid, s in self._stores.items()
                    if s.array is not None and sid != keep]
        resident.sort()
        total = sum(s.nbytes for _, _, s in resident)
        if keep is not None and keep in self._stores:
            total += self._stores[keep].nbytes
        for _, sid, store in resident:
            if total <= self.memory_budget_bytes:
                break
            store.host = store.array.cpu()
            store.array = None
            if self._stm.enabled:
                self._stm.note("store", (self._stm_dom, sid),
                               "SPILLED", site="_enforce_budget")
            total -= store.nbytes

    # ---- content-addressed routine memoization (core/cache.py) ----
    def _cache_invalidate(self, handle_id: int, outputs_only: bool) -> None:
        """Drop cache entries touching ``handle_id`` and release their
        retained output references. Runs under the state lock; the
        release may cascade (freeing an output reclaims its binding,
        which invalidates further entries) — the cache pops entries
        before we release, so the recursion terminates."""
        if self.cache is None:
            return
        dropped = self.cache.invalidate_output(handle_id) if outputs_only \
            else self.cache.invalidate_handle(handle_id)
        for entry in dropped:
            self.cache_log.record(entry.session, entry.label, "invalidate")
            self._release_entry_outputs(entry)

    def _release_entry_outputs(self, entry: caching.CacheEntry) -> None:
        """Give back the refcounts the cache took on a dead entry's
        outputs (a handle already reclaimed free()s as a no-op)."""
        for h in entry.outputs:
            self.free(h)

    def _cache_info(self, cmd: protocol.Command
                    ) -> Optional[tuple[str, tuple[int, ...]]]:
        """Cache key + input-handle IDs for a command, or None when it
        must not be memoized: engine builtins, unknown routines (they
        fail on their own), routines declaring ``writes`` (side effects)
        or ``nocache``, commands with no handle args at all (creation
        routines and test shims — params alone are no evidence the
        result is worth pinning), deferred args (submit-time only; by
        run time they are real handles), or handles this session cannot
        resolve. Call under the state lock."""
        if self.cache is None or cmd.library == ENGINE_LIBRARY:
            return None
        fn = self._libraries.get(cmd.library, {}).get(cmd.routine)
        if fn is None or getattr(fn, "writes", None) or \
                getattr(fn, "nocache", False):
            return None
        inputs: list[int] = []

        def fp_of(h: MatrixHandle) -> str:
            entry = self._entries.get(h.id)
            if entry is None or entry.session not in (
                    cmd.session, SYSTEM_SESSION):
                raise caching.Uncacheable(f"handle #{h.id} unresolvable")
            inputs.append(h.id)
            return self._stores[entry.store].fingerprint

        # keys are scoped by the session's execution backend: a reference
        # session must never be served a torch-computed result (recomputing
        # with the other implementation is its whole point)
        key = caching.routine_key(cmd.library, cmd.routine, cmd.args, fp_of,
                                  scope=self._backend_name(cmd.session))
        if key is None or not inputs:
            return None
        return key, tuple(inputs)

    def _deliver_cached(self, entry: caching.CacheEntry,
                        session: int) -> dict:
        """Materialize a cache entry's values for ``session``: handles
        owned by the session are re-delivered with one extra reference
        (so the client's eventual free balances, hit or miss); handles
        owned by another session are *aliased* into this namespace —
        session A's cached result never leaks A's handle IDs into B's
        namespace, B gets its own bindings over the shared stores."""
        def rebind(v):
            if isinstance(v, MatrixHandle):
                binding = self._entry(v)
                if binding.session == session:
                    binding.refs += 1
                    return v
                return self._alias_store(binding.store, session,
                                         name=v.name)
            if isinstance(v, dict):
                return {k: rebind(x) for k, x in v.items()}
            if isinstance(v, list):
                return [rebind(x) for x in v]
            if isinstance(v, tuple):
                return tuple(rebind(x) for x in v)
            return v

        return rebind(entry.values)

    def _serve_hit(self, key: str, entry: caching.CacheEntry,
                   cmd: protocol.Command, state: str = "") -> protocol.Result:
        """Deliver one cache hit (call under the state lock): rebind the
        memoized values into the requesting session, account it, touch
        the entry's LRU position. Shared by the submit fast path and the
        dispatch-time lookup so the two hit paths cannot diverge."""
        self.cache.peek(key)                 # LRU/hit-count touch
        values = self._deliver_cached(entry, cmd.session)
        self.cache_log.record(cmd.session, f"{cmd.library}.{cmd.routine}",
                              "hit", saved_s=entry.exec_s)
        # .get, not []: the session may have disconnected between the
        # caller's liveness check and this hit being served — a stale
        # hit is harmless, a KeyError here kills the submit endpoint
        sess = self._sessions.get(cmd.session)
        if sess is not None:
            sess.commands += 1
        return protocol.Result(values=values, session=cmd.session,
                               state=state, cache_hit=True,
                               saved_s=entry.exec_s)

    def _cache_fast_path(self, cmd: protocol.Command) -> Optional[bytes]:
        """DONE-on-submit: serve a memoized result without minting a task.

        Guarded against the scheduler's hazard edges: a hit is refused
        while any input or cached-output handle has a QUEUED/RUNNING
        writer, and while a barrier (library loading — which may
        invalidate this very entry) is in flight — the task path would
        have ordered this command after those, so the fast path must not
        run ahead of them (it falls through to normal scheduling, and
        the dispatch-time lookup re-checks once the edges drained)."""
        with self._state_lock:
            info = self._cache_info(cmd)
            if info is None:
                return None
            key, inputs = info
            entry = self.cache.get(key)      # non-touching: may refuse
            if entry is None:
                return None
            guard = set(inputs) | {h.id for h in entry.outputs}
            if self.scheduler.pending_writers(guard) or \
                    self.scheduler.pending_barrier():
                return None
            return protocol.encode_result(
                self._serve_hit(key, entry, cmd, state=scheduling.DONE))

    def _cache_store_result(self, key: str, inputs: tuple[int, ...],
                            cmd: protocol.Command, values: dict,
                            exec_s: float) -> None:
        """Memoize a freshly computed result: retain every output handle
        (a client free or LRU spill must not invalidate the entry),
        rebind the outputs' stores onto *derived* fingerprints (equal
        computations mint equal fingerprints, so memoization composes
        transitively), and record the miss. LRU-evicted entries give
        their retained references back."""
        label = f"{cmd.library}.{cmd.routine}"
        with self._state_lock:
            self.cache_log.record(cmd.session, label, "miss")
            if key in self.cache:
                return          # raced by a concurrent identical task
            outputs: list[tuple[str, MatrixHandle]] = []

            def walk(path, v):
                if isinstance(v, MatrixHandle):
                    outputs.append((path, v))
                elif isinstance(v, dict):
                    for k in sorted(v, key=str):
                        walk(f"{path}.{k}", v[k])
                elif isinstance(v, (list, tuple)):
                    for i, x in enumerate(v):
                        walk(f"{path}[{i}]", x)

            walk("", values)
            if any(h.id not in self._entries for _, h in outputs):
                return          # an output was already freed: not cacheable
            for path, h in outputs:
                binding = self._entries[h.id]
                binding.refs += 1
                store = self._stores[binding.store]
                if store.fingerprint.startswith("v:"):
                    # opaque version -> derived content address (leave
                    # streamed-content and already-derived prints alone)
                    if self._by_fingerprint.get(store.fingerprint) == \
                            binding.store:
                        del self._by_fingerprint[store.fingerprint]
                    store.fingerprint = caching.derived_fingerprint(
                        key, path)
                    self._by_fingerprint.setdefault(store.fingerprint,
                                                    binding.store)
            evicted = self.cache.store(
                key, values, [h for _, h in outputs], inputs,
                exec_s=exec_s, label=label, session=cmd.session)
            for old in evicted:
                self._release_entry_outputs(old)

    # ---- 2D engine layout (Elemental DistMatrix analogue) ----
    def dist_layout(self, shape) -> str:
        """The engine-native layout tag for ``shape``: rows over the
        worker axis when they divide evenly (the DistMatrix row-block
        layout), replicated otherwise — the JAX engine's
        ``dist_sharding`` rule, read as the tag ``layout_of`` derives
        from it. With one worker every array of rank >= 1 is row-block
        and a scalar is replicated."""
        if len(shape) >= 1 and shape[0] % self.num_workers == 0:
            return ROWBLOCK
        return REPLICATED

    def layout(self, handle: MatrixHandle) -> str:
        """The authoritative layout of the store a handle names (the
        handle's own tag is a snapshot from mint time)."""
        with self._state_lock:
            return self._stores[self._entry(handle).store].layout

    # ---- dispatch (async task scheduler over the command channel) ----
    def run(self, wire_command: bytes) -> bytes:
        """Execute one serialized Command; returns a serialized Result.

        Blocking semantics, now built as submit + wait on the task
        scheduler: the command becomes a task, ordered after this
        session's earlier tasks and any handle hazards, and the call
        blocks until it reaches a terminal state. Concurrent clients'
        independent commands overlap on the worker pool instead of
        head-of-line blocking each other. A routine-cache hit returns at
        submit time (``cache_hit`` set, no task minted) with nothing to
        wait for.
        """
        wire_sub = self.submit(wire_command)
        sub = protocol.decode_result(wire_sub)
        if sub.error:
            return protocol.encode_result(sub)
        if sub.cache_hit:
            return wire_sub
        return self.wait_task(sub.task, session=sub.session)

    def submit(self, wire_command: bytes) -> bytes:
        """Enqueue one serialized Command as an asynchronous task; returns
        immediately with a Result whose ``task``/``state`` name the new
        table entry. Submission fails fast (no task minted) on
        undecodable bytes, the system session, or an unknown session;
        library/routine existence is checked at *execution* time so a
        submitted ``_engine.load_library`` can satisfy later submissions.

        A command whose routine-cache key hits (and whose handles have no
        in-flight writer) takes the DONE-on-submit fast path: the reply
        carries the memoized values with ``cache_hit=True``, ``task=0``,
        and no task is ever minted.
        """
        with self._state_lock:
            self.endpoint_counts["submit"] += 1
        try:
            cmd = protocol.decode_command(wire_command)
        except Exception as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}"))
        if cmd.session == SYSTEM_SESSION:
            # the system namespace is the trusted in-process principal;
            # wire clients must connect() and use their own session
            return protocol.encode_result(protocol.Result(
                values={}, error="commands cannot execute in the system "
                                 "session; connect() a session first",
                session=cmd.session))
        try:
            self.session(cmd.session)
        except UnknownSession as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}",
                session=cmd.session))
        reads, writes, data_deps = self._hazards(cmd)
        # deferred handles are session-scoped like everything else: a
        # client may only chain on its *own* tasks (same isolation rule
        # task_op enforces for poll/wait)
        for dep in sorted(data_deps):
            try:
                producer = self.scheduler.task(dep)
            except KeyError as e:
                return protocol.encode_result(protocol.Result(
                    values={}, error=f"KeyError: {e}",
                    session=cmd.session))
            if producer.session != cmd.session:
                return protocol.encode_result(protocol.Result(
                    values={}, error=f"KeyError: task #{dep} does not "
                    f"belong to session #{cmd.session}",
                    session=cmd.session))
        if not data_deps and not writes and self.cache is not None:
            fast = self._cache_fast_path(cmd)
            if fast is not None:
                return fast
        # admission control (core/qos): checked AFTER the cache fast
        # path — a memoized answer costs the engine nothing, so serving
        # it to an over-quota tenant is strictly better than bouncing —
        # and BEFORE any task is minted, so a denial commits no state.
        price = 0.0
        if self.admission is not None:
            price = self._task_price(cmd)
            denial = self.admission.admit_submit(
                cmd.session, weight=self._session_weight(cmd.session),
                queue_depth=self.scheduler.session_depth(cmd.session),
                resident_bytes=self._session_resident_bytes(cmd.session),
                est_exec_s=price)
            if denial is not None:
                reason, retry = denial
                return protocol.encode_result(protocol.Result(
                    values={}, error=f"AlchemistBusyError: {reason}",
                    session=cmd.session, retry_after_s=retry))
        barrier = cmd.library == ENGINE_LIBRARY
        try:
            # Re-validate liveness under the state lock, held across the
            # task mint: the unlocked session() check above can race
            # disconnect, and a task minted after its drain observed an
            # empty table would execute against a freed namespace.
            # disconnect flips ``draining`` under this same lock before
            # it drains, which closes the window (engine.state ->
            # scheduler.cv is the documented lock order).
            with self._state_lock:
                sess = self._sessions.get(cmd.session)
                if sess is None or sess.draining:
                    raise UnknownSession(
                        f"session #{cmd.session} is not connected to "
                        "this engine")
                task = self.scheduler.submit(
                    lambda t, c=cmd: self._run_task(c, t),
                    session=cmd.session,
                    reads=reads, writes=writes, data_deps=data_deps,
                    barrier=barrier,
                    label=f"{cmd.library}.{cmd.routine}",
                    payload=cmd, price=price)
        except Exception as e:   # e.g. scheduler shut down: stay on-wire
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}",
                session=cmd.session))
        return protocol.encode_result(protocol.Result(
            values={"task": task.id}, session=cmd.session,
            task=task.id, state=task.state))

    def task_op(self, wire_op: bytes) -> bytes:
        """Protocol endpoint for poll/wait. ``poll`` replies with the
        task's current state without blocking; ``wait`` blocks until the
        task is terminal and replies with its full Result (queue-wait vs
        execute split included). Tasks are session-scoped: a client may
        only observe its own."""
        with self._state_lock:
            self.endpoint_counts["task_op"] += 1
        try:
            op = protocol.decode_task_op(wire_op)
            task = self.scheduler.task(op.task)
            if task.session != op.session:
                raise KeyError(
                    f"task #{op.task} does not belong to session "
                    f"#{op.session}")
        except Exception as e:
            return protocol.encode_result(protocol.Result(
                values={}, error=f"{type(e).__name__}: {e}"))
        if op.action == protocol.WAIT:
            try:
                return self.wait_task(op.task, session=op.session)
            except Exception as e:   # e.g. a concurrent waiter released
                return protocol.encode_result(protocol.Result(
                    values={}, error=f"{type(e).__name__}: {e}",
                    session=op.session))
        return protocol.encode_result(protocol.Result(
            values={"task": task.id, "state": task.state},
            session=op.session, task=task.id, state=task.state,
            wait_s=task.wait_s, exec_s=task.exec_s))

    def wait_task(self, task_id: int, session: int) -> bytes:
        """Block until a task is terminal; return its Result bytes with
        the task id, final state, and wait/execute timing stamped in.

        Delivery releases the task's table row (unless a dependent still
        needs it): wait is how results leave the engine, and long-lived
        sessions issuing millions of blocking calls must not accumulate
        rows. Deferred placeholders are therefore valid until their
        producer's result is delivered — after that the client holds the
        real handles (``AlFuture`` caches them)."""
        task = self.scheduler.wait(task_id)
        if task.result is not None:
            res = protocol.decode_result(task.result)
        else:
            res = protocol.Result(
                values={}, error=task.error or "task failed",
                session=session)
        res = dataclasses.replace(
            res, task=task.id, state=task.state,
            wait_s=task.wait_s, exec_s=task.exec_s)
        self.scheduler.release(task_id)
        return protocol.encode_result(res)

    def _hazards(self, cmd: protocol.Command
                 ) -> tuple[set[int], set[int], set[int]]:
        """Scheduling constraints read off a command's args: handle args
        are reads (writes when the routine declares that arg in its
        ``writes`` attribute), deferred handles are data dependencies on
        their producer tasks. The routine's declaration is consulted
        best-effort — an unloaded library simply yields no write set,
        which is safe for the read-only ALI routines."""
        reads: set[int] = set()
        writes: set[int] = set()
        data_deps: set[int] = set()
        fn = self._libraries.get(cmd.library, {}).get(cmd.routine)
        written_args = set(getattr(fn, "writes", ()) or ())

        def walk(key, v):
            if isinstance(v, MatrixHandle):
                (writes if key in written_args else reads).add(v.id)
            elif isinstance(v, protocol.DeferredHandle):
                data_deps.add(v.task)
            elif isinstance(v, dict):
                for x in v.values():
                    walk(key, x)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(key, x)

        for k, v in cmd.args.items():
            walk(k, v)
        return reads, writes, data_deps

    def _resolve_deferred(self, cmd: protocol.Command) -> protocol.Command:
        """Swap DeferredHandle placeholders for the real MatrixHandles
        their producer tasks minted. Runs on the worker thread just
        before dispatch; producers are guaranteed terminal (data edges)
        and DONE (failed producers fail the consumer in the scheduler)."""
        def resolve(v):
            if isinstance(v, protocol.DeferredHandle):
                producer = self.scheduler.task(v.task)
                res = protocol.decode_result(producer.result)
                out = res.values.get(v.key)
                if not isinstance(out, MatrixHandle):
                    raise KeyError(
                        f"task #{v.task} produced no handle named "
                        f"{v.key!r} (outputs: {sorted(res.values)})")
                return out
            if isinstance(v, dict):
                return {k: resolve(x) for k, x in v.items()}
            if isinstance(v, list):
                return [resolve(x) for x in v]
            return v

        return dataclasses.replace(cmd, args=resolve(cmd.args))

    def _lookup_routine(self, cmd: protocol.Command):
        """The library's cataloged callable for a command — the spec
        carrier and legacy-ALI fallback, *never* invoked directly by the
        engine for backend-registered routines. Raises
        LibraryNotRegistered with the pre-ABI messages."""
        if cmd.library == ENGINE_LIBRARY:
            fn = self._BUILTINS.get(cmd.routine)
            if fn is None:
                raise LibraryNotRegistered(
                    f"routine {cmd.routine!r} not in {ENGINE_LIBRARY!r}")
            return fn
        lib = self._libraries.get(cmd.library)
        if lib is None:
            raise LibraryNotRegistered(
                f"library {cmd.library!r} not registered")
        fn = lib.get(cmd.routine)
        if fn is None:
            raise LibraryNotRegistered(
                f"routine {cmd.routine!r} not in {cmd.library!r}")
        return fn

    def _run_task(self, cmd: protocol.Command,
                  task: Optional[scheduling.Task] = None) -> bytes:
        """Task body run on a scheduler worker: resolve deferred args,
        consult the routine cache, build the execution plan, dispatch it
        through the session's backend, memoize and encode the Result. A
        total exception barrier converts every failure (unresolvable
        deferred, routine raising, unserializable outputs) into an
        encoded error Result raised as TaskFailure, so the task lands in
        FAILED with the error available to waiters — and the worker pool
        survives.

        When the command's implementation is fusible and the session
        allows it, the engine *claims* the chain of queued commands
        depending only on this task (``scheduler.claim_chain``) and
        executes the whole chain as one fused backend program — see
        :meth:`_run_fused`.

        The cache lookup here needs no hazard guard: by dispatch time
        every write this task was ordered after has completed (its edges
        drained), so input fingerprints — and therefore the key — already
        reflect those writes. This is also what catches hits the submit
        fast path had to refuse while a writer was in flight."""
        if self._qos_policy is not None:
            # cooperative preemption: iterative implementations call
            # backends.base.yield_check() at iteration boundaries; the
            # hook is per-worker-thread and cleared in the finally
            backend_base.set_yield_check(
                lambda s=cmd.session: self._qos_yield(s))
        try:
            cmd = self._resolve_deferred(cmd)
            sess = self.session(cmd.session)
            fn = self._lookup_routine(cmd)
            backend = self._session_backend(sess)
            if cmd.library == ENGINE_LIBRARY:
                impl = backend_base.RoutineImpl(fn=fn, kind=backend_base.ALI)
            else:
                impl = backend.routine_impl(cmd.library, cmd.routine,
                                            fallback=fn)
            info = None
            if self.cache is not None:
                with self._state_lock:
                    info = self._cache_info(cmd)
                    if info is not None:
                        entry = self.cache.get(info[0])
                        if entry is not None:
                            return protocol.encode_result(
                                self._serve_hit(info[0], entry, cmd))
            chain: list[scheduling.Task] = []
            if (task is not None and self.fuse_chains and sess.fusion
                    and backend.supports_fusion and impl.fusible
                    and impl.kind == backend_base.ARRAY):
                chain = self.scheduler.claim_chain(
                    task.id, self._fusible_predicate(backend))
            if chain:
                return self._run_fused(task, cmd, impl, chain, backend,
                                       sess)
            meta = {"ops": 1, "relayouts": 0, "relayout_bytes": 0}
            sess.commands += 1
            t0 = time.perf_counter()
            values = self._execute_step(backend, impl, cmd, sess, meta)
            elapsed = time.perf_counter() - t0
            if task is not None:
                with self._state_lock:
                    self._task_meta[task.id] = meta
            if info is not None:
                self._cache_store_result(info[0], info[1], cmd, values,
                                         elapsed)
            return protocol.encode_result(protocol.Result(
                values=values, elapsed=elapsed, session=cmd.session))
        except LibraryNotRegistered as e:
            raise scheduling.TaskFailure(
                protocol.encode_result(protocol.Result(
                    values={}, error=str(e), session=cmd.session)),
                str(e))
        except Exception as e:
            msg = f"{type(e).__name__}: {e}"
            raise scheduling.TaskFailure(
                protocol.encode_result(protocol.Result(
                    values={}, error=msg, session=cmd.session)), msg)
        finally:
            if self._qos_policy is not None:
                backend_base.set_yield_check(None)

    # ---- backend execution (the plan layer) ----
    def _execute_step(self, backend: backend_base.ExecutionBackend,
                      impl: backend_base.RoutineImpl,
                      cmd: protocol.Command, sess: Session,
                      meta: dict) -> dict:
        """Run one command through the ABI: materialize handle args
        (negotiating layout), invoke the implementation, and mint output
        handles through the distributed put path. Legacy ALI impls keep
        the old calling convention — the routine does its own
        ``engine.put`` via the session view."""
        if impl.kind == backend_base.ALI:
            view = SessionView(self, sess)
            values = impl.fn(view, **cmd.args)
            self._sync()
            return values
        kwargs = {}
        inputs: dict[str, Any] = {}
        plan_args: dict[str, Any] = {}
        for k, v in cmd.args.items():
            if isinstance(v, MatrixHandle):
                arr = self._materialize_arg(v, cmd.session, backend,
                                            impl, meta)
                kwargs[k] = arr
                slot = f"i{len(inputs)}"
                inputs[slot] = arr
                plan_args[k] = backend_base.Input(slot)
            else:
                kwargs[k] = v
                plan_args[k] = v
        if (impl.fusible and impl.bucketable and inputs
                and self._session_policy(sess).enabled
                and hasattr(backend, "get_or_compile")):
            # bucket-eligible single op: run through the (AOT-warmed,
            # shape-keyed) program cache instead of eager dispatch, so
            # a padded tenant shape hits a pre-compiled bucket
            # executable instead of tracing on its first call
            plan = backend_base.ExecutionPlan(steps=[
                backend_base.PlanStep(library=cmd.library,
                                      routine=cmd.routine,
                                      args=plan_args, impl=impl)])
            program, run_inputs, crops = self._prepare_program(
                backend, plan, inputs, sess)
            outs_list = program(run_inputs)
            if crops is not None:
                outs_list = self._crop_outputs(backend, outs_list, crops)
            self._sync()
            return self._bind_outputs(backend, outs_list[0], cmd)
        outs = impl.fn(**kwargs)
        self._sync()
        return self._bind_outputs(backend, outs, cmd)

    def _sync(self) -> None:
        """Wait for the device's queued work, so the step's seconds (its
        ``elapsed``, the scheduler's ``exec_s``, the QoS debt reconciled
        against it) measure the work and not just its launches."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _materialize_arg(self, handle: MatrixHandle, session: int,
                         backend: backend_base.ExecutionBackend,
                         impl: backend_base.RoutineImpl, meta: dict):
        """Handle -> backend-native array, inserting an explicit relayout
        when the store's layout is not one the implementation accepts
        (the Elemental redistribution step, made visible and charged to
        the task's accounting)."""
        arr = self.get(handle, session=session)
        with self._state_lock:
            lay = self._stores[self._entry(handle).store].layout
        if impl.accepts is not None and lay not in impl.accepts:
            # one device holds the whole tensor in every layout, so the
            # redistribution to impl.relayout_to moves nothing here; it
            # is counted as the JAX engine counts its device_put
            meta["relayouts"] += 1
            meta["relayout_bytes"] += arr.numel() * arr.element_size()
        return backend.to_native(arr)

    def _bind_outputs(self, backend: backend_base.ExecutionBackend,
                      outs: dict, cmd: protocol.Command) -> dict:
        """Mint handles for a step's array outputs — every one lands
        through :meth:`_put_output`'s dist-sharding path, so backend
        results (including host-side reference results and transposes
        that lost their sharding) re-enter the engine layout. Scalars
        pass through untouched."""
        if not isinstance(outs, dict):
            raise TypeError(
                f"{cmd.library}.{cmd.routine} implementation must return "
                f"a dict of outputs, got {type(outs).__name__}")
        arrays = [k for k, v in outs.items() if backend.is_array(v)]
        arg_name = cmd.args.get("name")
        values = {}
        for k, v in outs.items():
            if backend.is_array(v):
                name = arg_name if (len(arrays) == 1
                                    and isinstance(arg_name, str)) \
                    else f"{cmd.routine}.{k}"
                values[k] = self._put_output(v, cmd.session, name=name)
            else:
                values[k] = v
        return values

    def _put_output(self, value, session: int,
                    name: Optional[str] = None) -> MatrixHandle:
        """The single exit point for routine outputs: land the array on
        the engine device, contiguous, tagged with the engine's
        distributed layout (:meth:`dist_layout`), and register it. This
        is what guarantees no routine output ever drops the engine layout
        — host-side reference results and transposed views included."""
        value = self._on_device(value).contiguous()
        return self.put(value, name=name, session=session,
                        layout=self.dist_layout(tuple(value.shape)))

    def _fusible_predicate(self, backend: backend_base.ExecutionBackend):
        """Claim filter for :meth:`scheduler.claim_chain`: a queued task
        is fusible when it carries a decoded Command for a *loaded*
        routine this backend registered as fusible (legacy ALI fallbacks
        never are). Runs under the scheduler lock, so it must not take
        the engine state lock (``pending_writers`` is called under the
        state lock — the reverse order would deadlock); the two dict
        reads below are single lookups, safe without it."""
        def ok(t: scheduling.Task) -> bool:
            c = t.payload
            if not isinstance(c, protocol.Command) or \
                    c.library == ENGINE_LIBRARY:
                return False
            if self._libraries.get(c.library, {}).get(c.routine) is None:
                return False      # unloaded: must fail like eager dispatch
            return backend.fusible(c.library, c.routine)
        return ok

    def _run_fused(self, task: scheduling.Task, cmd: protocol.Command,
                   impl: backend_base.RoutineImpl,
                   chain: list[scheduling.Task],
                   backend: backend_base.ExecutionBackend,
                   sess: Session) -> bytes:
        """Execute a claimed chain as ONE backend program (the headline
        optimization): build a multi-step plan where chain-internal
        deferred handles become :class:`StepRef` SSA edges, compile it
        through the backend (the jax backend emits a single ``jax.jit``
        program), then mint every step's outputs and complete the
        claimed tasks in chain order.

        Caching: each step's result is stored under the *same* canonical
        key — and therefore mints the same derived output fingerprints —
        as op-by-op execution would (keys hash content + params, not
        dispatch shape), so memoization composes identically fused or
        not. Per-step cache *lookups* are skipped (the chain recomputes);
        the lead's own lookup already ran in :meth:`_run_task`.

        If compilation or the fused run fails, fall back to sequential
        per-step execution with eager failure semantics: steps before
        the failure still succeed, the failing step and everything
        data-dependent on it fail — exactly what unfused dispatch would
        have produced."""
        cmds = [cmd] + [t.payload for t in chain]
        task_index = {task.id: 0}
        for i, t in enumerate(chain):
            task_index[t.id] = i + 1
        meta = {"ops": len(cmds), "relayouts": 0, "relayout_bytes": 0}

        impls = [impl]
        for c in cmds[1:]:
            impls.append(backend.routine_impl(c.library, c.routine))

        inputs: dict[str, Any] = {}
        slot_of: dict[int, str] = {}

        def plan_arg(v, step_impl):
            if isinstance(v, MatrixHandle):
                slot = slot_of.get(v.id)
                if slot is None:
                    # positional slot names: the same chain *shape* from
                    # another tenant (different handle IDs, same
                    # structure) reuses the backend's compiled program
                    slot = f"i{len(slot_of)}"
                    inputs[slot] = self._materialize_arg(
                        v, cmd.session, backend, step_impl, meta)
                    slot_of[v.id] = slot
                return backend_base.Input(slot)
            if isinstance(v, protocol.DeferredHandle):
                j = task_index.get(v.task)
                if j is not None:
                    return backend_base.StepRef(j, v.key)
                # external producer: terminal by claim construction —
                # resolve to its real handle, then treat as an input
                producer = self.scheduler.task(v.task)
                res = protocol.decode_result(producer.result)
                out = res.values.get(v.key)
                if not isinstance(out, MatrixHandle):
                    raise KeyError(
                        f"task #{v.task} produced no handle named "
                        f"{v.key!r} (outputs: {sorted(res.values)})")
                return plan_arg(out, step_impl)
            return v

        try:
            steps = []
            for c, step_impl in zip(cmds, impls):
                steps.append(backend_base.PlanStep(
                    library=c.library, routine=c.routine,
                    args={k: plan_arg(v, step_impl)
                          for k, v in c.args.items()},
                    impl=step_impl))
            plan = backend_base.ExecutionPlan(steps=steps)
            program, run_inputs, crops = self._prepare_program(
                backend, plan, inputs, sess)
            t0 = time.perf_counter()
            outs_list = program(run_inputs)
            if crops is not None:
                outs_list = self._crop_outputs(backend, outs_list, crops)
            elapsed = time.perf_counter() - t0
        except Exception:
            # fused lowering/execution failed; re-run with eager,
            # per-step failure semantics (implementations are pure, so
            # nothing partial leaked)
            return self._run_chain_unfused(task, cmds, chain, backend,
                                           sess)

        share = elapsed / len(cmds)
        lead_wire: Optional[bytes] = None
        minted: dict[int, dict] = {}     # chain position -> values
        try:
            for i, (c, outs) in enumerate(zip(cmds, outs_list)):
                sess.commands += 1
                resolved = dataclasses.replace(
                    c, args=self._chain_concrete_args(c, task_index,
                                                      minted))
                values = self._bind_outputs(backend, outs, resolved)
                minted[i] = values
                if self.cache is not None:
                    with self._state_lock:
                        step_info = self._cache_info(resolved)
                    if step_info is not None:
                        self._cache_store_result(
                            step_info[0], step_info[1], resolved, values,
                            share)
                wire = protocol.encode_result(protocol.Result(
                    values=values, elapsed=share, session=c.session))
                if i == 0:
                    with self._state_lock:
                        self._task_meta[task.id] = meta
                    lead_wire = wire
                else:
                    t = chain[i - 1]
                    if i == len(cmds) - 1:
                        # the chain tail is what the client is waiting
                        # on, but the lead only completes when this body
                        # returns to its worker — record the lead NOW
                        # (its own step already delivered) so observing
                        # the tail's result implies the full chain's
                        # accounting is readable
                        with self._state_lock:
                            meta["recorded"] = True
                        self.task_log.record(
                            session=task.session, label=task.label,
                            state=scheduling.DONE, wait_s=task.wait_s,
                            exec_s=time.perf_counter() - task.started_at,
                            fused_ops=meta.get("ops", 1), absorbed=False,
                            relayouts=meta.get("relayouts", 0),
                            relayout_bytes=meta.get("relayout_bytes", 0))
                    with self._state_lock:
                        self._task_meta[t.id] = {"absorbed": True}
                    self.scheduler.finish_claimed(t.id, wire)
        except Exception as e:
            # Claimed tasks were promised a finish_claimed call — a
            # delivery failure (impl returned outputs that don't match
            # its spec, unserializable values, ...) must not strand them
            # in RUNNING forever. Fail every not-yet-completed claimed
            # task; the lead keeps its own outcome (DONE if its step
            # already delivered — eager semantics — FAILED otherwise,
            # via _run_task's barrier).
            msg = f"{type(e).__name__}: {e}"
            err_wire = protocol.encode_result(protocol.Result(
                values={}, error=msg, session=cmd.session))
            for t in chain:
                try:
                    self.scheduler.finish_claimed(
                        t.id, err_wire, state=scheduling.FAILED,
                        error=msg)
                except KeyError:
                    pass        # this one already completed
            if lead_wire is None:
                raise
        return lead_wire

    def _chain_concrete_args(self, c: protocol.Command,
                             task_index: dict[int, int],
                             minted: dict[int, dict]) -> dict:
        """Rewrite a chain command's args with the handles its chain-
        internal deferred refs resolved to (the outputs were just
        minted) — what cache keying and hazard-truthful Results need."""
        def concrete(v):
            if isinstance(v, protocol.DeferredHandle):
                j = task_index.get(v.task)
                if j is not None:
                    out = minted.get(j, {}).get(v.key)
                    if not isinstance(out, MatrixHandle):
                        raise KeyError(
                            f"chain step {j} produced no handle named "
                            f"{v.key!r}")
                    return out
                producer = self.scheduler.task(v.task)
                res = protocol.decode_result(producer.result)
                return res.values[v.key]
            if isinstance(v, dict):
                return {k: concrete(x) for k, x in v.items()}
            if isinstance(v, list):
                return [concrete(x) for x in v]
            return v
        return {k: concrete(v) for k, v in c.args.items()}

    def _run_chain_unfused(self, task: scheduling.Task,
                           cmds: list[protocol.Command],
                           chain: list[scheduling.Task],
                           backend: backend_base.ExecutionBackend,
                           sess: Session) -> bytes:
        """Sequential fallback for a claimed chain whose fused execution
        failed: run each step eagerly (same per-step semantics as
        normal dispatch), fail the first broken step, and fail every
        later step as an upstream casualty — then surface the lead's
        own outcome to the worker."""
        task_ids = [task.id] + [t.id for t in chain]
        task_index = {tid: i for i, tid in enumerate(task_ids)}
        minted: dict[int, dict] = {}
        failed_at: Optional[int] = None
        failed_msg = ""
        lead_wire: Optional[bytes] = None
        lead_error: Optional[str] = None
        for i, c in enumerate(cmds):
            backend_base.yield_check()   # QoS boundary between steps
            if failed_at is not None:
                msg = (f"upstream task #{task_ids[failed_at]} failed: "
                       f"{failed_msg}")
                wire = protocol.encode_result(protocol.Result(
                    values={}, error=msg, session=c.session))
                self.scheduler.finish_claimed(chain[i - 1].id, wire,
                                              state=scheduling.FAILED,
                                              error=msg)
                continue
            try:
                resolved = dataclasses.replace(
                    c, args=self._chain_concrete_args(c, task_index,
                                                      minted))
                impl_i = backend.routine_impl(
                    resolved.library, resolved.routine,
                    fallback=self._lookup_routine(resolved))
                meta_i = {"ops": 1, "relayouts": 0, "relayout_bytes": 0}
                sess.commands += 1
                t0 = time.perf_counter()
                values = self._execute_step(backend, impl_i, resolved,
                                            sess, meta_i)
                elapsed = time.perf_counter() - t0
                minted[i] = values
                if i > 0:       # claimed steps never dispatched on a worker
                    meta_i["absorbed"] = True
                with self._state_lock:
                    self._task_meta[task_ids[i]] = meta_i
                if self.cache is not None:
                    with self._state_lock:
                        info_i = self._cache_info(resolved)
                    if info_i is not None:
                        self._cache_store_result(info_i[0], info_i[1],
                                                 resolved, values, elapsed)
                wire = protocol.encode_result(protocol.Result(
                    values=values, elapsed=elapsed, session=c.session))
                if i == 0:
                    lead_wire = wire
                else:
                    self.scheduler.finish_claimed(chain[i - 1].id, wire)
            except Exception as e:
                failed_at = i
                failed_msg = f"{type(e).__name__}: {e}"
                wire = protocol.encode_result(protocol.Result(
                    values={}, error=failed_msg, session=c.session))
                if i == 0:
                    lead_wire = wire
                    lead_error = failed_msg
                else:
                    self.scheduler.finish_claimed(
                        chain[i - 1].id, wire, state=scheduling.FAILED,
                        error=failed_msg)
        if lead_error is not None:
            raise scheduling.TaskFailure(lead_wire, lead_error)
        return lead_wire

    # ---- engine builtins (wire-reachable under ENGINE_LIBRARY) ----
    @specs.routine(outputs=())
    def _builtin_load_library(view, name: str, module: str):
        """Wire path for library registration: import ``module`` by path
        and register its ROUTINES under ``name``. Submitted as a scheduler
        *barrier*, so loading serializes with every in-flight task — no
        routine observes a half-registered library, mirroring dlopen()
        under the MPI world lock."""
        view._engine.load_library(name, importlib.import_module(module))
        return {"library": name, "loaded": True}

    @specs.routine(outputs=())
    def _builtin_compile_stats(view):
        """Wire path for compile accounting: the engine-wide CompileLog
        summary (traces, AOT vs on-demand, bucket hit-rate, compile
        seconds on/off the request path) plus program-cache occupancy
        and executable-index size under ``"engine"``, and the calling
        session's own compile summary under ``"session"`` — how a tenant
        checks whether its traffic is being absorbed by warmed buckets."""
        eng = view._engine
        return {"engine": eng.compile_stats(),
                "session": eng.compile_log.session_summary(view.session.id)}

    @specs.routine(outputs=())
    def _builtin_qos_stats(view):
        """Wire path for QoS accounting: the engine-wide QosLog summary
        (admitted/rejected/throttled/preempted/completed, reconciled
        debt seconds, p50/p99 queue wait per weight class) plus whether
        QoS is enabled and, when it is, the per-session ready-queue
        depths — how a tenant checks whether it is being throttled and
        what its fair share is buying."""
        return view._engine.qos_stats()

    _BUILTINS = {"load_library": _builtin_load_library,
                 "compile_stats": _builtin_compile_stats,
                 "qos_stats": _builtin_qos_stats}

    def _record_task(self, task: scheduling.Task) -> None:
        """Scheduler completion hook -> per-task cost accounting,
        including the backend-ABI execution metadata (fused op count,
        absorbed flag, relayout count/bytes) staged by the task body.

        A fused chain's lead is recorded early by :meth:`_run_fused`
        (before the chain tail's result is released) so a client that
        observed the tail also observes the whole chain's accounting —
        skip the duplicate here."""
        with self._state_lock:
            meta = self._task_meta.pop(task.id, None) or {}
        if meta.get("recorded"):
            return
        self.task_log.record(
            session=task.session, label=task.label, state=task.state,
            wait_s=task.wait_s, exec_s=task.exec_s,
            fused_ops=meta.get("ops", 1),
            absorbed=bool(meta.get("absorbed", False)),
            relayouts=meta.get("relayouts", 0),
            relayout_bytes=meta.get("relayout_bytes", 0))
