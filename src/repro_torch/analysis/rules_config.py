"""CFG001 — configure(...) surface parity.

The session-configuration option set is declared once, in
``repro_torch.core.configopts.OPTIONS``; this rule checks every surface that
exposes it against that registry (the FRAME_SPECS pattern):

* ``engine.configure`` must validate against ``configopts.SUPPORTED``
  and gate QoS options on ``configopts.QOS_OPTIONS`` — no hardcoded
  literal option sets that can drift.
* ``protocol.Configure``'s docstring must mention every option (it is
  the wire-level contract a client author reads).
* ``context.AlchemistContext.configure`` must accept every option as a
  keyword parameter, and accept nothing that is not an option — the
  typed client surface is exactly the registry.
* the server CLI must define every flag an option declares
  (``--compile-cache-dir``, ``--warmup``, ``--no-bucketing``).

Parameterizable for the violating-fixture tests: pass ``options`` and
any of the four paths to point the rule at crafted inputs.
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from repro_torch.analysis.findings import Finding
from repro_torch.core import configopts


def _core_path(*parts) -> str:
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(src, "repro_torch", "core", *parts)


def _parse(path: str) -> ast.AST:
    with open(path, "r") as f:
        return ast.parse(f.read())


def _find_def(tree: ast.AST, name: str):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _find_class(tree: ast.AST, name: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _dotted_names(node: ast.AST) -> set[str]:
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute):
            parts = [n.attr]
            v = n.value
            while isinstance(v, ast.Attribute):
                parts.append(v.attr)
                v = v.value
            if isinstance(v, ast.Name):
                parts.append(v.id)
            out.add(".".join(reversed(parts)))
    return out


def check_config_surface(options=None,
                         engine_path: Optional[str] = None,
                         protocol_path: Optional[str] = None,
                         context_path: Optional[str] = None,
                         server_path: Optional[str] = None
                         ) -> list[Finding]:
    if options is None:
        options = configopts.OPTIONS
    engine_path = engine_path or _core_path("engine.py")
    protocol_path = protocol_path or _core_path("protocol.py")
    context_path = context_path or _core_path("context.py")
    server_path = server_path or _core_path("server.py")
    names = [o.name for o in options]
    out: list[Finding] = []

    # -- engine: validation must consume the registry, not a literal set
    etree = _parse(engine_path)
    conf = _find_def(etree, "configure")
    if conf is None:
        out.append(Finding(
            rule="CFG001", file=engine_path, line=1,
            symbol="engine.configure",
            message="engine has no configure() endpoint to validate "
                    "options against the registry"))
    else:
        dotted = _dotted_names(conf)
        for want in ("configopts.SUPPORTED", "configopts.QOS_OPTIONS"):
            if not any(d == want or d.endswith("." + want)
                       for d in dotted):
                out.append(Finding(
                    rule="CFG001", file=engine_path, line=conf.lineno,
                    symbol=f"engine.configure:{want.split('.')[-1]}",
                    message=f"engine.configure does not reference "
                            f"{want} — option validation must come "
                            "from the single-source registry "
                            "(core/configopts.py), not a literal set"))

    # -- protocol: the wire contract's docstring names every option
    ptree = _parse(protocol_path)
    cls = _find_class(ptree, "Configure")
    if cls is None:
        out.append(Finding(
            rule="CFG001", file=protocol_path, line=1,
            symbol="protocol.Configure",
            message="protocol has no Configure dataclass"))
    else:
        doc = ast.get_docstring(cls) or ""
        for name in names:
            if f"``{name}``" not in doc and name not in doc.split():
                out.append(Finding(
                    rule="CFG001", file=protocol_path, line=cls.lineno,
                    symbol=f"protocol.Configure:{name}",
                    message=f"protocol.Configure docstring does not "
                            f"mention option {name!r} — the wire "
                            "contract a client author reads has "
                            "drifted from the registry"))

    # -- context: the typed client signature is exactly the registry
    ctree = _parse(context_path)
    cconf = _find_def(ctree, "configure")
    if cconf is None:
        out.append(Finding(
            rule="CFG001", file=context_path, line=1,
            symbol="context.configure",
            message="context has no configure() client method"))
    else:
        params = {a.arg for a in (cconf.args.args
                                  + cconf.args.kwonlyargs)} - {"self"}
        for name in names:
            if name not in params:
                out.append(Finding(
                    rule="CFG001", file=context_path, line=cconf.lineno,
                    symbol=f"context.configure:{name}",
                    message=f"context.configure() does not accept "
                            f"option {name!r} — clients cannot reach a "
                            "registered option"))
        for extra in sorted(params - set(names)):
            out.append(Finding(
                rule="CFG001", file=context_path, line=cconf.lineno,
                symbol=f"context.configure:{extra}",
                message=f"context.configure() accepts {extra!r}, which "
                        "is not in the option registry — either "
                        "register it in core/configopts.py or drop it"))

    # -- server CLI: every declared flag exists
    stree = _parse(server_path)
    flags: set[str] = set()
    for node in ast.walk(stree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    flags.add(a.value)
    for o in options:
        if o.cli is not None and o.cli not in flags:
            out.append(Finding(
                rule="CFG001", file=server_path, line=1,
                symbol=f"server.cli:{o.name}",
                message=f"option {o.name!r} declares server CLI flag "
                        f"{o.cli!r} but the server's argument parser "
                        "does not define it"))
    return out
