"""CAT — catalog parity between the spec-only library catalog and every
registered backend.

The engine's contract (the backend ABI) is that ``describe`` serves
one catalog and *any* registered backend can serve it: a routine that
exists in the spec but not in a backend silently degrades to the legacy
ALI fallback (or fails), flag drift between backends changes which
chains fuse depending on who executes them, and a ``bucketable``
declaration without a shape rule makes warmup *silently skip*
the routine — exactly the class of quiet drift this rule family turns
into lint errors.

Rules:

* **CAT001** missing impl — a cataloged ``(library, routine)`` has no
  implementation in some registered backend.
* **CAT002** orphan impl — a backend registers a routine the catalog
  does not declare (dead code or a typo'd name that will never be
  dispatched).
* **CAT003** flag drift — ``fusible`` / ``bucketable`` /
  has-shape-rule differ between backends for the same routine. The
  flags describe the *routine* (purity, pad-safety), not the backend:
  whether a backend actually fuses is ``supports_fusion``.
* **CAT004** bucketable without a shape rule — ``bucketable=True`` but
  ``out_shapes is None``: warmup cannot enumerate buckets and the
  engine cannot crop padded outputs.
* **CAT005** output arity — the spec's declared outputs must all appear
  among the statically-known keys of the implementation's ``return
  {...}`` dicts (checked only when every return is a literal dict, so
  dynamic impls never false-positive).

All checks run on the *imported* registries (introspection, not source
grep), so they see exactly what the engine sees; only CAT005 reads
source, via ``inspect.getsource`` on the registered function. The
backends checked by default are the port's two, ``TorchBackend`` and
its ``ReferenceBackend``, against the port's catalog
(``repro_torch.core.libraries``).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Optional

from repro_torch.analysis.findings import Finding


def _default_libraries() -> dict:
    from repro_torch.core.libraries import elemental, mllib, skylark
    return {"elemental": elemental, "skylark": skylark, "mllib": mllib}


def _default_backends() -> list:
    from repro_torch.core.backends.reference import ReferenceBackend
    from repro_torch.core.backends.torch_backend import TorchBackend
    return [TorchBackend(), ReferenceBackend()]


def _spec_site(spec, module) -> tuple[str, int]:
    fn = getattr(spec, "fn", None)
    try:
        return (inspect.getsourcefile(fn) or module.__file__,
                inspect.getsourcelines(fn)[1])
    except (OSError, TypeError):
        return module.__file__, 1


def _impl_site(impl) -> tuple[str, int]:
    try:
        return (inspect.getsourcefile(impl.fn) or "?",
                inspect.getsourcelines(impl.fn)[1])
    except (OSError, TypeError):
        return "?", 1


def _returned_keys(fn) -> Optional[set[str]]:
    """The union of keys across ``return {...}`` statements, or ``None``
    when any return is not a fully-literal dict (unknowable statically:
    ``**spread``, computed keys, helper calls, bare names)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, SyntaxError, TypeError):
        return None
    fndef = next((n for n in tree.body
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))), None)
    if fndef is None:
        return None
    keys: set[str] = set()
    saw_return = False
    for node in ast.walk(fndef):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fndef:
            continue                      # nested defs return elsewhere
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        saw_return = True
        if not isinstance(node.value, ast.Dict):
            return None
        for k in node.value.keys:
            if k is None:                 # {**spread}
                return None
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
            else:
                return None
    return keys if saw_return else None


def check_catalog_parity(libraries: Optional[dict] = None,
                         backends: Optional[list] = None
                         ) -> list[Finding]:
    libraries = _default_libraries() if libraries is None else libraries
    backends = _default_backends() if backends is None else backends
    out: list[Finding] = []

    specs: dict[tuple[str, str], object] = {}
    for lib_name, module in libraries.items():
        for rt_name, spec in getattr(module, "ROUTINES", {}).items():
            specs[(lib_name, rt_name)] = (spec, module)

    cataloged_libs = set(libraries)
    for be in backends:
        served = set(be.routines())
        # CAT001 — every cataloged routine has an impl in this backend
        for (lib, rt), (spec, module) in sorted(specs.items()):
            if (lib, rt) not in served:
                file, line = _spec_site(spec, module)
                out.append(Finding(
                    rule="CAT001", file=file, line=line,
                    symbol=f"{lib}.{rt}@{be.name}",
                    message=f"cataloged routine {lib}.{rt} has no "
                            f"implementation in backend {be.name!r} "
                            "(would silently fall back to legacy ALI "
                            "dispatch)"))
        # CAT002 — no orphan registrations against the checked catalog
        for (lib, rt) in sorted(served):
            if lib in cataloged_libs and (lib, rt) not in specs:
                impl = be.routine_impl(lib, rt)
                file, line = _impl_site(impl)
                out.append(Finding(
                    rule="CAT002", file=file, line=line,
                    symbol=f"{lib}.{rt}@{be.name}",
                    message=f"backend {be.name!r} registers {lib}.{rt} "
                            "but the library catalog does not declare "
                            "it — unreachable via describe/submit"))

    # CAT003 — flags agree across every backend pair that serves it
    for (lib, rt) in sorted(specs):
        flagged = [(be, be.routine_impl(lib, rt)) for be in backends
                   if be.supports(lib, rt)]
        for be, impl in flagged[1:]:
            ref_be, ref_impl = flagged[0]
            drift = []
            if impl.fusible != ref_impl.fusible:
                drift.append(f"fusible ({ref_be.name}="
                             f"{ref_impl.fusible}, {be.name}="
                             f"{impl.fusible})")
            if impl.bucketable != ref_impl.bucketable:
                drift.append(f"bucketable ({ref_be.name}="
                             f"{ref_impl.bucketable}, {be.name}="
                             f"{impl.bucketable})")
            if (impl.out_shapes is None) != (ref_impl.out_shapes is None):
                drift.append("out_shapes rule presence")
            if drift:
                file, line = _impl_site(impl)
                out.append(Finding(
                    rule="CAT003", file=file, line=line,
                    symbol=f"{lib}.{rt}",
                    message=f"{lib}.{rt} flags drift between backends: "
                            + "; ".join(drift)
                            + " (flags describe the routine, not the "
                              "backend — they must match everywhere)"))

    for be in backends:
        for (lib, rt) in sorted(be.routines()):
            impl = be.routine_impl(lib, rt)
            # CAT004 — bucketable requires a shape rule
            if impl.bucketable and impl.out_shapes is None:
                file, line = _impl_site(impl)
                out.append(Finding(
                    rule="CAT004", file=file, line=line,
                    symbol=f"{lib}.{rt}@{be.name}",
                    message=f"{lib}.{rt} in backend {be.name!r} is "
                            "bucketable but has no out_shapes rule — "
                            "warmup silently skips it and padded "
                            "outputs cannot be cropped"))
            # CAT005 — declared outputs appear in the returned dict
            spec_entry = specs.get((lib, rt))
            if spec_entry is None:
                continue
            spec, module = spec_entry
            declared = tuple(getattr(spec, "outputs", ()) or ())
            if not declared:
                continue
            known = _returned_keys(impl.fn)
            if known is None:
                continue                 # dynamic return: unprovable
            missing = [o for o in declared if o not in known]
            if missing:
                file, line = _impl_site(impl)
                out.append(Finding(
                    rule="CAT005", file=file, line=line,
                    symbol=f"{lib}.{rt}@{be.name}",
                    message=f"{lib}.{rt} in backend {be.name!r} never "
                            f"returns declared output(s) "
                            f"{', '.join(missing)} (spec outputs "
                            f"{declared}, returned keys "
                            f"{sorted(known)})"))
    return out
