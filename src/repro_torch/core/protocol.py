"""Driver<->driver wire protocol (the paper's socket message layer, §3.1.2).

Three message kinds cross the client/engine boundary, all msgpack-encoded:

* ``Handshake`` — the connect/disconnect exchange that opens and closes a
  client session (the paper's driver attaching to the Alchemist driver and
  being assigned worker resources, §3.1.1). ``connect`` mints a session ID;
  ``disconnect`` releases everything that session owns.
* ``Command`` — one routine invocation, tagged with the issuing session so
  the engine can resolve matrix handles inside that session's namespace.
  A Command delivered to ``engine.run`` executes blocking (submit+wait); the
  same bytes delivered to ``engine.submit`` enqueue an asynchronous task and
  return immediately with a task ID. Args may carry
  :class:`DeferredHandle` placeholders naming the not-yet-produced outputs
  of earlier submitted tasks (server-side chaining with zero client round
  trips — the paper's §3.3.2 resident-matrix chaining, now pipelined).
* ``TaskOp`` — ``poll`` (non-blocking state query) or ``wait`` (block until
  terminal) against a previously submitted task, scoped to the owning
  session.
* ``Describe`` — catalog discovery: ask the engine for the typed routine
  schemas (``core/libraries/spec.py``) of one loaded library, or of all of
  them. The reply's ``values["libraries"]`` maps library name to
  ``{"routines": {name: spec-dict}}``; clients rebuild ``RoutineSpec``
  objects with ``spec.from_wire`` and validate calls *before* submitting
  anything (the fail-fast half of the ACI).
* ``Configure`` — session configuration: select the execution backend
  this session's commands run in (``core/backends``), and toggle chain
  fusion. The engine validates against its registry and echoes the
  effective settings.
* ``Result`` — values, timing, the echoing session, and an ``error`` string
  (empty on success) so engine-side failures propagate as data instead of
  exceptions, exactly like an error status on the socket. For scheduled
  tasks it also reports the task ID, its state, and the queue-wait vs
  execute split (``wait_s``/``exec_s``).

Distributed matrices never cross here — they move through the transfer
layer (``core/transfer.py``, §3.2) and are referenced by handle ID. Running
every call through an explicit encode/decode keeps the bridge honest: only
serializable scalars, strings and handle IDs can cross, exactly like the
real system's serialized input parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import msgpack

_HANDLE_TAG = "__handle__"
_DEFERRED_TAG = "__deferred__"

CONNECT = "connect"
DISCONNECT = "disconnect"

POLL = "poll"
WAIT = "wait"


@dataclasses.dataclass(frozen=True)
class Handshake:
    """Session-management message (§3.1.1 driver attach/detach).

    ``action`` is ``"connect"`` (client name travels in ``client``; the
    engine replies with a fresh session ID) or ``"disconnect"`` (``session``
    names the session to tear down).
    """
    action: str
    client: str = ""
    session: int = 0


@dataclasses.dataclass(frozen=True)
class Command:
    """One serialized routine invocation (§3.1.2).

    ``library``/``routine`` name the ALI entry point; ``args`` may contain
    scalars, strings, and MatrixHandles; ``session`` scopes handle
    resolution to the issuing client's namespace.
    """
    library: str
    routine: str
    args: dict[str, Any]
    session: int = 0


@dataclasses.dataclass(frozen=True)
class DeferredHandle:
    """A placeholder for the not-yet-existing output of a submitted task.

    ``task`` is the producing task's ID, ``key`` the name of the output in
    its Result values (e.g. the ``"Q"`` of a ``qr`` call). Passing one as a
    Command arg makes the engine (a) add a dependency edge on the producer
    and (b) resolve the placeholder to the real MatrixHandle just before
    the consumer runs — chained calls pipeline engine-side while the
    client keeps submitting.
    """
    task: int
    key: str


@dataclasses.dataclass(frozen=True)
class Describe:
    """Catalog query: the typed routine schemas of ``library`` (or every
    loaded library when empty). ``session`` must name a connected
    session — discovery is a client action like any other."""
    library: str = ""
    session: int = 0


@dataclasses.dataclass(frozen=True)
class Configure:
    """Session configuration: select the execution environment this
    session's commands run in. ``options`` currently understands
    ``backend`` (a registered backend name, e.g. ``"jax"`` /
    ``"reference"``), ``fusion`` (bool; opt a session out of chain
    fusion, e.g. to benchmark the unfused dispatch path), ``bucketing``
    (bool; opt this session in/out of operand shape bucketing),
    ``warmup`` (True, or a list of bucket sizes: AOT-compile the
    bucketable catalog + indexed hot signatures now, off the request
    path), ``cache_dir`` (str; engine-wide persistent compile cache
    directory — see ``core/compilecache.py``), and — on QoS-enabled
    engines only — ``weight`` (positive number; this tenant's
    fair-share dispatch weight) and ``quotas`` (dict; per-session
    admission quota overrides). The full option table lives in
    ``core/configopts.py`` (the CFG001 rule keeps every surface in
    sync with it). The engine validates every option and echoes the
    effective settings; unknown option keys are rejected — a typo must
    not silently configure nothing."""
    session: int
    options: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TaskOp:
    """Task-table query: ``poll`` returns the task's current state without
    blocking; ``wait`` blocks until DONE/FAILED and returns its Result.
    ``session`` must be the task's owning session (task isolation)."""
    action: str
    task: int
    session: int = 0


@dataclasses.dataclass(frozen=True)
class Result:
    """Engine reply to a Command, TaskOp or Handshake (§3.1.2).

    ``error`` is empty on success; on failure it carries the engine-side
    exception rendered as ``"ExcType: message"``. ``session`` echoes the
    session the reply belongs to. Replies about scheduled tasks carry the
    ``task`` ID, its ``state`` (QUEUED/RUNNING/DONE/FAILED) and the
    latency split: ``wait_s`` queued behind dependencies and worker
    availability, ``exec_s`` actually executing (``elapsed`` keeps the
    legacy meaning: routine execution time).

    ``cache_hit=True`` marks a result served from the engine's
    content-addressed routine cache instead of being computed; ``saved_s``
    then reports the original run's execute time — what this client did
    not wait for. A cache hit at *submit* time comes back with
    ``state="DONE"`` and ``task=0``: no task was ever minted (the
    DONE-on-submit fast path).

    ``retry_after_s`` is non-zero only on admission-control denials
    (``error`` starts with ``AlchemistBusyError``): the engine's estimate
    of when capacity frees up, which the client's backoff loop honors
    instead of guessing (core/qos).
    """
    values: dict[str, Any]
    elapsed: float = 0.0
    error: str = ""
    session: int = 0
    task: int = 0
    state: str = ""
    wait_s: float = 0.0
    exec_s: float = 0.0
    cache_hit: bool = False
    saved_s: float = 0.0
    retry_after_s: float = 0.0


def _pack_value(v):
    from repro_torch.core.handles import MatrixHandle

    if isinstance(v, MatrixHandle):
        return {_HANDLE_TAG: [v.id, list(v.shape), v.dtype, v.layout, v.name]}
    if isinstance(v, DeferredHandle):
        return {_DEFERRED_TAG: [v.task, v.key]}
    if isinstance(v, (list, tuple)):
        return [_pack_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _pack_value(x) for k, x in v.items()}
    if isinstance(v, (int, float, str, bool, bytes)) or v is None:
        return v
    raise TypeError(
        f"cannot serialize {type(v).__name__} across the Alchemist boundary; "
        "only scalars, strings and MatrixHandles may cross (send matrices "
        "through the transfer layer)")


def _unpack_value(v):
    from repro_torch.core.handles import MatrixHandle

    if isinstance(v, dict):
        if _HANDLE_TAG in v:
            hid, shape, dtype, layout, name = v[_HANDLE_TAG]
            return MatrixHandle(id=hid, shape=tuple(shape), dtype=dtype,
                                layout=layout, name=name)
        if _DEFERRED_TAG in v:
            task, key = v[_DEFERRED_TAG]
            return DeferredHandle(task=task, key=key)
        return {k: _unpack_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unpack_value(x) for x in v]
    return v


def encode_handshake(hs: Handshake) -> bytes:
    """Serialize a connect/disconnect message."""
    if hs.action not in (CONNECT, DISCONNECT):
        raise ValueError(f"unknown handshake action {hs.action!r}")
    return msgpack.packb({
        "action": hs.action,
        "client": hs.client,
        "session": hs.session,
    })


def decode_handshake(data: bytes) -> Handshake:
    """Inverse of :func:`encode_handshake`."""
    d = msgpack.unpackb(data)
    return Handshake(action=d["action"], client=d.get("client", ""),
                     session=d.get("session", 0))


def encode_command(cmd: Command) -> bytes:
    """Serialize a Command; rejects values that must not cross the bridge."""
    return msgpack.packb({
        "library": cmd.library,
        "routine": cmd.routine,
        "args": _pack_value(cmd.args),
        "session": cmd.session,
    })


def decode_command(data: bytes) -> Command:
    """Inverse of :func:`encode_command`."""
    d = msgpack.unpackb(data)
    # session is mandatory on the wire: defaulting a missing field to the
    # system namespace would silently grant it system-handle visibility.
    return Command(library=d["library"], routine=d["routine"],
                   args=_unpack_value(d["args"]), session=d["session"])


def encode_describe(d: Describe) -> bytes:
    """Serialize a catalog query."""
    return msgpack.packb({
        "library": d.library,
        "session": d.session,
    })


def decode_describe(data: bytes) -> Describe:
    """Inverse of :func:`encode_describe` (session mandatory, like
    Command: discovery must not default into the system namespace)."""
    d = msgpack.unpackb(data)
    return Describe(library=d.get("library", ""), session=d["session"])


def encode_configure(c: Configure) -> bytes:
    """Serialize a session-configuration message (options must already be
    plain scalars — there is nothing handle-valued to configure)."""
    return msgpack.packb({
        "session": c.session,
        "options": _pack_value(dict(c.options)),
    })


def decode_configure(data: bytes) -> Configure:
    """Inverse of :func:`encode_configure` (session mandatory, like
    Command: configuration must not default into the system namespace)."""
    d = msgpack.unpackb(data)
    return Configure(session=d["session"],
                     options=_unpack_value(d.get("options", {})) or {})


def encode_task_op(op: TaskOp) -> bytes:
    """Serialize a poll/wait task query."""
    if op.action not in (POLL, WAIT):
        raise ValueError(f"unknown task-op action {op.action!r}")
    return msgpack.packb({
        "action": op.action,
        "task": op.task,
        "session": op.session,
    })


def decode_task_op(data: bytes) -> TaskOp:
    """Inverse of :func:`encode_task_op`."""
    d = msgpack.unpackb(data)
    # like Command.session: a missing session must not default to system
    return TaskOp(action=d["action"], task=d["task"], session=d["session"])


def encode_result(res: Result) -> bytes:
    """Serialize a Result (values + timing + error + session echo)."""
    return msgpack.packb({
        "values": _pack_value(res.values),
        "elapsed": res.elapsed,
        "error": res.error,
        "session": res.session,
        "task": res.task,
        "state": res.state,
        "wait_s": res.wait_s,
        "exec_s": res.exec_s,
        "cache_hit": res.cache_hit,
        "saved_s": res.saved_s,
        "retry_after_s": res.retry_after_s,
    })


def decode_result(data: bytes) -> Result:
    """Inverse of :func:`encode_result` (task/timing fields default for
    pre-scheduler wire bytes)."""
    d = msgpack.unpackb(data)
    return Result(values=_unpack_value(d["values"]), elapsed=d["elapsed"],
                  error=d["error"], session=d.get("session", 0),
                  task=d.get("task", 0), state=d.get("state", ""),
                  wait_s=d.get("wait_s", 0.0), exec_s=d.get("exec_s", 0.0),
                  cache_hit=d.get("cache_hit", False),
                  saved_s=d.get("saved_s", 0.0),
                  retry_after_s=d.get("retry_after_s", 0.0))
