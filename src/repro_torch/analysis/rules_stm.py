"""STM — lifecycle state-machine conformance (static AST pass).

Checks the core sources against the declarative machine specs in
:mod:`repro_torch.analysis.statemachine`:

* **STM001** undeclared transition site — a guarded lifecycle field is
  mutated in a function the machine does not declare. Every such
  mutation is (or races) a state transition; an undeclared one is
  invisible to review, to the runtime monitor, and to the docs tables.
* **STM002** missing declared site — a declared site function no longer
  exists in the machine's modules. The spec has drifted from the code
  (usually a rename); fix the spec or the code, never ignore it.
* **STM003** transition outside the owning lock — a mutation inside a
  declared site is not lexically under ``with self.<lockattr>`` (and the
  site is not declared ``caller_locked``). Lifecycle fields are exactly
  the state the lock exists to guard.
* **STM004** missing obligation call — a declared site does not
  (lexically) make a call its obligation demands, e.g. teardown without
  releasing reservations. Suffix-matched on dotted call names.

All parameterizable for the violating-fixture tests: pass ``machines``
and/or ``root`` to point the pass at crafted specs and files.
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from repro_torch.analysis import statemachine
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.statemachine import Machine

#: dict/set/list methods that mutate their receiver — a call like
#: ``self._sessions.pop(...)`` is as much a transition as an assignment
_MUTATING_METHODS = frozenset({
    "pop", "popitem", "clear", "setdefault", "update", "add", "discard",
    "remove", "append", "extend", "insert", "appendleft", "popleft",
})


def _repo_src() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _guarded_attr(node: ast.AST, guarded: frozenset) -> Optional[str]:
    """The guarded attribute a statement mutates, or None.

    Recognizes ``x.attr = / += / del``, ``x.attr[k] = / del``, and
    mutating method calls ``x.attr.pop(...)`` / ``x.attr[k].append`` is
    *not* matched (the subscripted element is not the guarded mapping).
    """
    def attr_of(t: ast.expr) -> Optional[str]:
        if isinstance(t, ast.Attribute) and t.attr in guarded:
            return t.attr
        if isinstance(t, ast.Subscript):
            v = t.value
            if isinstance(v, ast.Attribute) and v.attr in guarded:
                return v.attr
        return None

    if isinstance(node, ast.Assign):
        for t in node.targets:
            targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for tt in targets:
                hit = attr_of(tt)
                if hit:
                    return hit
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return attr_of(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            hit = attr_of(t)
            if hit:
                return hit
    elif isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATING_METHODS:
            v = fn.value
            if isinstance(v, ast.Attribute) and v.attr in guarded:
                return v.attr
    return None


def _mentions_attr(node: ast.expr, attr: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == attr
               for n in ast.walk(node))


def _dotted(fn: ast.expr) -> Optional[str]:
    parts: list[str] = []
    node = fn
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif not parts:
        return None
    return ".".join(reversed(parts))


class _ModuleScan:
    """One parse of one module: guarded-field mutations attributed to
    their *outermost* function (nested helpers belong to the method that
    defines them), each tagged with whether it sits lexically inside a
    ``with self.<lockattr>`` block; plus the set of function names and
    the dotted call names made inside each."""

    def __init__(self, tree: ast.AST, guarded: frozenset,
                 lockattr: Optional[str]):
        self.mutations: list[tuple[Optional[str], int, str, bool]] = []
        self.functions: dict[str, ast.AST] = {}
        self.calls: dict[str, set[str]] = {}
        self._guarded = guarded
        self._lockattr = lockattr
        self._walk(tree, func=None, locked=False)

    def _walk(self, node: ast.AST, func: Optional[str],
              locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if func is None:
                self.functions[node.name] = node
                self.calls.setdefault(node.name, set())
                func = node.name
            for child in ast.iter_child_nodes(node):
                self._walk(child, func, locked)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            covers = self._lockattr is not None and any(
                _mentions_attr(item.context_expr, self._lockattr)
                for item in node.items)
            for item in node.items:
                self._walk(item, func, locked)
            for stmt in node.body:
                self._walk(stmt, func, locked or covers)
            return
        hit = _guarded_attr(node, self._guarded)
        if hit is not None:
            self.mutations.append((func, node.lineno, hit, locked))
        if isinstance(node, ast.Call) and func is not None:
            dotted = _dotted(node.func)
            if dotted:
                self.calls[func].add(dotted)
        for child in ast.iter_child_nodes(node):
            self._walk(child, func, locked)


def _obligation_met(calls: set[str], required: str) -> bool:
    return any(c == required or c.endswith("." + required) for c in calls)


def check_statemachines(machines: Optional[tuple[Machine, ...]] = None,
                        root: Optional[str] = None) -> list[Finding]:
    """Run STM001–STM004 over every machine's modules."""
    if machines is None:
        machines = statemachine.MACHINES
    if root is None:
        root = os.path.join(_repo_src(), "repro_torch")
    out: list[Finding] = []
    trees: dict[str, ast.AST] = {}
    for m in machines:
        sites = set(m.sites)
        caller_locked = set(m.caller_locked)
        scans: list[tuple[str, _ModuleScan]] = []
        for mod in m.modules:
            path = os.path.join(root, mod)
            if path not in trees:
                with open(path, "r") as f:
                    trees[path] = ast.parse(f.read())
            scans.append((path, _ModuleScan(
                trees[path], frozenset(m.guarded), m.lockattr)))

        defined = set()
        for _, scan in scans:
            defined.update(scan.functions)
        for site in sorted(sites - defined):
            out.append(Finding(
                rule="STM002", file=scans[0][0], line=1,
                symbol=f"{m.name}.{site}",
                message=f"machine {m.name!r} declares transition site "
                        f"{site!r} but no such function exists in "
                        f"{', '.join(m.modules)} — the spec drifted "
                        "from the code"))

        for path, scan in scans:
            for func, lineno, attr, locked in scan.mutations:
                where = func or "<module>"
                if func not in sites:
                    out.append(Finding(
                        rule="STM001", file=path, line=lineno,
                        symbol=f"{m.name}.{where}.{attr}",
                        message=f"guarded lifecycle field {attr!r} of "
                                f"machine {m.name!r} mutated in "
                                f"{where!r}, which is not a declared "
                                "transition site"))
                elif m.lockattr is not None and func not in caller_locked \
                        and not locked:
                    out.append(Finding(
                        rule="STM003", file=path, line=lineno,
                        symbol=f"{m.name}.{where}.{attr}",
                        message=f"transition site {where!r} mutates "
                                f"{attr!r} outside `with self."
                                f"{m.lockattr}` — machine {m.name!r} is "
                                f"owned by lock {m.lock!r}"))

        for ob in m.obligations:
            calls: set[str] = set()
            site_path = None
            for path, scan in scans:
                if ob.site in scan.calls:
                    calls |= scan.calls[ob.site]
                    site_path = site_path or path
            if site_path is None:
                continue        # STM002 already flagged the missing site
            for req in ob.must_call:
                if not _obligation_met(calls, req):
                    out.append(Finding(
                        rule="STM004", file=site_path,
                        line=getattr(next(
                            scan.functions[ob.site] for _, scan in scans
                            if ob.site in scan.functions), "lineno", 1),
                        symbol=f"{m.name}.{ob.site}.{req}",
                        message=f"site {ob.site!r} must call {req!r}: "
                                f"{ob.reason}"))
    return out
