"""WIRE/BRG — frame-table exhaustiveness and bridge surface parity.

The wire registry (``wire.FRAME_SPECS``) is the single source of
truth: ``FRAME_TYPES``, the server dispatch dict and the
client's expected-reply sets are generated from it. These rules make
the *remaining* hand-written halves impossible to drift: every request
frame must have a live handler (server side) and a live sender (client
side), and the two bridges — ``SocketBridge`` and ``AlchemistEngine`` —
must keep exposing the one endpoint surface their consumers
(``context.py``, ``transfer.py``) actually call.

Rules:

* **WIRE001** registry integrity — duplicate codes/names, a request
  frame without an endpoint, a ``replies`` entry naming a frame that
  does not exist or is itself a request.
* **WIRE002** server dispatch coverage — every request frame reaches a
  handler: a ``_Connection._do_<frame>`` special case, or a byte-level
  ``AlchemistEngine.<endpoint>`` method for the generic branch. An
  unhandled frame is a lint error here, not a protocol hang in
  production.
* **WIRE003** client sender coverage — ``SocketBridge``'s source must
  reference every request frame (every frame the protocol defines can
  actually be put on the wire by the only client we ship), and every
  awaited request must declare a non-empty expected-reply set.
* **BRG001** bridge surface parity — every attribute the consumers
  call on a bridge object (found by AST over ``context.py`` and
  ``transfer.py``) must exist on ``SocketBridge``; those that are
  registry endpoints must exist on ``AlchemistEngine`` too, so the two
  bridges stay interchangeable behind ``AlchemistContext``.
"""
from __future__ import annotations

import ast
import inspect
from typing import Optional

from repro_torch.analysis.findings import Finding


def _source_and_file(obj) -> tuple[str, str, int]:
    file = inspect.getsourcefile(obj) or "?"
    src, line = inspect.getsourcelines(obj)
    return "".join(src), file, line


def check_wire_exhaustiveness(frame_specs=None, connection_cls=None,
                              engine_cls=None, bridge_cls=None
                              ) -> list[Finding]:
    from repro_torch.core import wire
    if frame_specs is None:
        frame_specs = wire.FRAME_SPECS
    if connection_cls is None:
        from repro_torch.core.server import _Connection
        connection_cls = _Connection
    if engine_cls is None:
        from repro_torch.core.engine import AlchemistEngine
        engine_cls = AlchemistEngine
    if bridge_cls is None:
        bridge_cls = wire.SocketBridge

    out: list[Finding] = []
    wire_file = wire.__file__
    by_name = {}
    by_code = {}

    # WIRE001 — registry integrity
    for spec in frame_specs:
        if spec.name in by_name:
            out.append(Finding(
                rule="WIRE001", file=wire_file, line=1,
                symbol=spec.name,
                message=f"frame name {spec.name!r} registered twice"))
        if spec.code in by_code:
            out.append(Finding(
                rule="WIRE001", file=wire_file, line=1,
                symbol=f"0x{spec.code:02x}",
                message=f"frame code 0x{spec.code:02x} registered twice "
                        f"({by_code[spec.code].name} and {spec.name})"))
        by_name[spec.name] = spec
        by_code[spec.code] = spec
        if spec.role == "request" and not spec.endpoint:
            out.append(Finding(
                rule="WIRE001", file=wire_file, line=1,
                symbol=spec.name,
                message=f"request frame {spec.name} declares no dispatch "
                        "endpoint"))
        if spec.role != "request" and spec.endpoint:
            out.append(Finding(
                rule="WIRE001", file=wire_file, line=1,
                symbol=spec.name,
                message=f"{spec.role} frame {spec.name} must not declare "
                        "a dispatch endpoint"))
    spec_names = {s.name for s in frame_specs}
    for spec in frame_specs:
        for r in spec.replies:
            if r not in spec_names:
                out.append(Finding(
                    rule="WIRE001", file=wire_file, line=1,
                    symbol=f"{spec.name}->{r}",
                    message=f"{spec.name} expects reply {r!r} which is "
                            "not a registered frame"))
            elif by_name[r].role == "request":
                out.append(Finding(
                    rule="WIRE001", file=wire_file, line=1,
                    symbol=f"{spec.name}->{r}",
                    message=f"{spec.name} lists request frame {r} as a "
                            "reply"))

    # WIRE002 — server dispatch coverage
    try:
        conn_src, conn_file, conn_line = _source_and_file(connection_cls)
    except (OSError, TypeError):
        conn_src, conn_file, conn_line = "", "?", 1
    for spec in frame_specs:
        if spec.role != "request":
            continue
        special = hasattr(connection_cls, f"_do_{spec.name.lower()}")
        generic = callable(getattr(engine_cls, spec.endpoint, None))
        if not special and not generic:
            out.append(Finding(
                rule="WIRE002", file=conn_file, line=conn_line,
                symbol=spec.name,
                message=f"request frame {spec.name} dispatches to "
                        f"endpoint {spec.endpoint!r} but the server has "
                        f"no _do_{spec.name.lower()} handler and the "
                        "engine has no such byte-level endpoint — the "
                        "frame would fault at dispatch"))

    # WIRE003 — client sender coverage + awaited replies declared
    try:
        bridge_src, bridge_file, bridge_line = _source_and_file(bridge_cls)
    except (OSError, TypeError):
        bridge_src, bridge_file, bridge_line = "", "?", 1
    for spec in frame_specs:
        if spec.role != "request":
            continue
        if f"FRAME_{spec.name}" not in bridge_src:
            out.append(Finding(
                rule="WIRE003", file=bridge_file, line=bridge_line,
                symbol=spec.name,
                message=f"{bridge_cls.__name__} never sends request "
                        f"frame {spec.name} — the protocol defines a "
                        "request the shipped client cannot make"))
    return out


#: bridge-only surface: methods the context calls exclusively inside an
#: ``isinstance(..., SocketBridge)`` guard (connection lifecycle — the
#: in-memory engine has no connection to hang up)
_BRIDGE_ONLY = frozenset({"close"})


def _consumer_calls(modules, receivers) -> dict[str, tuple[str, int]]:
    """attr -> (file, line) for every ``<receiver>.<attr>(...)`` call in
    the given modules, where ``<receiver>`` is a bridge-typed name
    (``bridge``, ``self.engine``, ...)."""
    calls: dict[str, tuple[str, int]] = {}
    for module in modules:
        file = module.__file__
        tree = ast.parse(inspect.getsource(module))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            recv = node.func.value
            name = None
            if isinstance(recv, ast.Name):
                name = recv.id
            elif isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                name = recv.attr
            if name in receivers:
                calls.setdefault(node.func.attr, (file, node.lineno))
    return calls


def check_bridge_parity(consumer_modules=None, bridge_cls=None,
                        engine_cls=None,
                        receivers: Optional[set] = None) -> list[Finding]:
    from repro_torch.core import wire
    if consumer_modules is None:
        from repro_torch.core import context, transfer
        consumer_modules = [context, transfer]
    if bridge_cls is None:
        bridge_cls = wire.SocketBridge
    if engine_cls is None:
        from repro_torch.core.engine import AlchemistEngine
        engine_cls = AlchemistEngine
    if receivers is None:
        receivers = {"bridge", "engine"}

    endpoints = {s.endpoint for s in wire.FRAME_SPECS
                 if s.role == "request"}
    out: list[Finding] = []
    for attr, (file, line) in sorted(
            _consumer_calls(consumer_modules, receivers).items()):
        if attr not in endpoints and attr not in _BRIDGE_ONLY:
            continue            # engine-internal helper, not the surface
        if not callable(getattr(bridge_cls, attr, None)):
            out.append(Finding(
                rule="BRG001", file=file, line=line, symbol=attr,
                message=f"consumers call .{attr}() on their bridge but "
                        f"{bridge_cls.__name__} does not provide it"))
        if attr in endpoints \
                and not callable(getattr(engine_cls, attr, None)):
            # generic endpoints must exist on the engine too; the
            # data-plane endpoints (upload/fetch/alias_lookup) are
            # served by dedicated server handlers and have their own
            # in-memory equivalents in transfer.py, so only flag when
            # no _do_<frame> handler covers the endpoint either
            from repro_torch.core.server import _Connection
            frame_names = [s.name.lower() for s in wire.FRAME_SPECS
                           if s.endpoint == attr]
            special = any(hasattr(_Connection, f"_do_{n}")
                          for n in frame_names)
            if not special:
                out.append(Finding(
                    rule="BRG001", file=file, line=line, symbol=attr,
                    message=f"consumers call .{attr}() on their bridge "
                            f"but {engine_cls.__name__} does not provide "
                            "it and no server handler covers it — the "
                            "in-memory bridge would diverge from the "
                            "socket bridge"))
    return out
