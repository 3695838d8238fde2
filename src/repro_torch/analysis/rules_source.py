"""TRC/PKL/LCK — source-level rules over the launch paths and wire code.

* **TRC001** capture and launch purity — no host synchronization, host
  data, I/O, clock reads or lock acquisition inside what a CUDA graph
  captures or what launches a kernel. The JAX package's rule of this
  name guards ``jax.jit`` traces, Pallas kernels and ``fusible=True``
  impls; the port's counterparts are:

  - the bodies registered for the ``CAPTURE_SAFE`` routines
    (``torch_backend.CAPTURE_SAFE``), found by registry introspection as
    the JAX rule finds the fusible set: these are what a chain's CUDA
    graph records. ``random_matrix``, ``qr`` and ``gram_svd`` are
    ``fusible`` too but never captured (they run eagerly, reading the
    host), so they are outside the scope;
  - every function of the kernel wrappers (``kernels/*/ops.py``) and of
    the kernel modules that launch (``kernels/<name>/<name>.py``);
  - the ``extern "C"`` launchers in ``csrc/*.cu``, by a plain text scan
    (comments stripped) for ``cudaDeviceSynchronize``,
    ``cudaStreamSynchronize``, ``cudaMemcpy(``, ``cudaMalloc(`` and
    ``cudaFree(``: the asynchronous forms are fine, these block the host
    or the device and are illegal in a capture.

  The banned Python calls: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize`` too),
  ``.acquire()``/``.release()``; ``torch.from_numpy``, ``torch.tensor``
  and ``torch.as_tensor`` (host data); ``np.asarray``, ``np.array`` and
  the like; ``print``/``open``/``input``; any ``time.*``,
  ``threading.*``, ``os.*`` or ``socket.*`` call; and ``with <lock>``.
  A sync inside a capture fails it (or, worse, bakes a stale host value
  into every replay); inside a launch it stalls the stream that should
  run ahead. ``LaunchCounter.add`` is allowed: it counts on the host,
  takes a lock no launch waits on, and inside a capture it records the
  launch so each replay adds it again by count. Preparing operands on
  the host (rf_map's weights, drawn with numpy from a seed) is not a
  launch: it lives in the plain module (``rf_map/ref.py``) and uploads
  asynchronously from pinned memory.
* **PKL001** no-pickle-on-wire — the user-data modules
  (``wire``/``transfer``/``protocol``/``server``) must never import or
  call ``pickle``-family deserializers (or ``eval``/``exec``). The
  transport's security stance is that a hostile peer can at worst hand
  back wrong numbers, never run code; one convenience ``pickle.loads``
  would end that.
* **LCK001** raw-lock discipline — ``repro_torch.core`` *and*
  ``repro_torch.kernels`` must construct every lock through
  ``repro_torch.analysis.locktrace``'s named factories. A raw
  ``threading.Lock()`` is invisible to the dynamic lock-order detector,
  which silently un-completes its view of the process. The JAX rule
  reads ``core`` alone, since Pallas kernels hold no host locks; the
  port's kernels build (``build.py``), settle the CPU's vector math and
  count launches (``device.py``) on host threads, under the backend's
  capture and program locks.
* **LCK002** rank-table integrity — every rank in
  ``locktrace.LOCK_RANKS`` is unique (the table IS the total order, no
  ambiguous ties), and the rank table documented in
  ``docs/torch_architecture.md`` (between the ``LOCK_RANK_TABLE``
  markers) matches the code exactly — the docs-vs-code drift that rank
  renumbering would otherwise cause is a gate failure.

All are AST passes (plus registry introspection for the capture-safe
set in TRC001, a text scan of the CUDA launchers, and the rank registry
in LCK002); suppression is by baseline fingerprint, not inline comments
— see docs/torch_architecture.md.
"""
from __future__ import annotations

import ast
import inspect
import os
import re
import textwrap
from typing import Iterable, Optional

from repro_torch.analysis.findings import Finding


def _repo_src() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _pkg_path(*parts) -> str:
    return os.path.join(_repo_src(), "repro_torch", *parts)


def _core_path(*parts) -> str:
    return _pkg_path("core", *parts)


def _py_files(root: str) -> list[str]:
    out = []
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return out


def _launch_files() -> list[str]:
    """Each kernel's wrapper (``ops.py``) and launch module
    (``<name>/<name>.py``)."""
    root = _pkg_path("kernels")
    out = []
    for name in sorted(os.listdir(root)):
        for f in ("ops.py", f"{name}.py"):
            path = os.path.join(root, name, f)
            if os.path.isfile(path):
                out.append(path)
    return out


def _cu_files() -> list[str]:
    root = _pkg_path("csrc")
    return [os.path.join(root, f) for f in sorted(os.listdir(root))
            if f.endswith(".cu")]


# ---- TRC001: capture and launch purity --------------------------------
#: attribute calls that force a device->host sync or take a lock
_BANNED_METHOD_CALLS = frozenset({
    "item", "tolist", "cpu", "numpy", "synchronize", "acquire", "release",
})
#: bare-name calls that are host-side I/O
_BANNED_NAME_CALLS = frozenset({"print", "open", "input"})
#: module-attr calls that bring host data in, read a clock, block or take
#: locks (``None``: any attribute)
_BANNED_MODULE_CALLS = {
    "torch": {"from_numpy", "tensor", "as_tensor"},
    "np": {"asarray", "array", "ascontiguousarray", "save", "load",
           "frombuffer"},
    "numpy": {"asarray", "array", "ascontiguousarray", "save", "load",
              "frombuffer"},
    "time": None,
    "threading": None,
    "os": None,
    "socket": None,
}
#: CUDA runtime calls a launcher must not make: they block the host or
#: the device (the ``Async`` forms are fine)
_BANNED_CUDA_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                      "cudaMemcpy(", "cudaMalloc(", "cudaFree(")


def _impure_nodes(fndef: ast.AST) -> Iterable[tuple[int, str]]:
    for node in ast.walk(fndef):
        if not isinstance(node, ast.Call):
            # `with lock:` in a launch is as bad as .acquire()
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    lock_name = None
                    if isinstance(ctx, ast.Attribute) \
                            and "lock" in ctx.attr.lower():
                        lock_name = ctx.attr
                    elif isinstance(ctx, ast.Name) \
                            and "lock" in ctx.id.lower():
                        lock_name = ctx.id
                    if lock_name is not None:
                        yield node.lineno, f"with {lock_name}: (lock " \
                            "held in a capture or launch)"
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _BANNED_NAME_CALLS:
            yield node.lineno, f"{fn.id}()"
        elif isinstance(fn, ast.Attribute):
            if fn.attr in _BANNED_METHOD_CALLS:
                yield node.lineno, f".{fn.attr}()"
            elif isinstance(fn.value, ast.Name):
                banned = _BANNED_MODULE_CALLS.get(fn.value.id, ())
                if banned is None or fn.attr in banned:
                    yield node.lineno, f"{fn.value.id}.{fn.attr}()"


def _scan_file_for_trace_purity(path: str) -> list[Finding]:
    """Every function of a wrapper or launch module."""
    with open(path, "r") as f:
        tree = ast.parse(f.read())
    out = []
    for fndef in ast.walk(tree):
        if not isinstance(fndef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for lineno, what in _impure_nodes(fndef):
            out.append(Finding(
                rule="TRC001", file=path, line=lineno,
                symbol=f"{os.path.basename(path)}:{fndef.name}",
                message=f"{what} inside kernel wrapper or launcher "
                        f"{fndef.name!r} — host sync/host data/I-O/"
                        "locking must stay outside what launches a "
                        "kernel or is captured into a CUDA graph"))
    return out


def _strip_c_comments(src: str) -> str:
    """``src`` with ``//`` and ``/* */`` comments blanked out, newlines
    kept so line numbers stay true."""
    def blank(m):
        return "".join(c if c == "\n" else " " for c in m.group(0))
    return re.sub(r"/\*.*?\*/|//[^\n]*", blank, src, flags=re.S)


def _c_launchers(src: str) -> Iterable[tuple[str, int, str]]:
    """(name, first line, body) of every ``extern "C"`` function
    definition in CUDA source ``src`` (comments already stripped)."""
    pos = 0
    while True:
        at = src.find('extern "C"', pos)
        if at < 0:
            return
        paren = src.find("(", at)
        brace = src.find("{", at)
        semi = src.find(";", at)
        pos = at + 1
        if paren < 0 or brace < 0 or (0 <= semi < brace):
            continue                      # a declaration, not a definition
        name = src[at:paren].split()[-1].lstrip("*&")
        depth, i = 0, brace
        while i < len(src):
            if src[i] == "{":
                depth += 1
            elif src[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        yield name, src.count("\n", 0, brace) + 1, src[brace:i + 1]
        pos = i + 1


def _scan_cu_for_trace_purity(path: str) -> list[Finding]:
    with open(path, "r") as f:
        src = _strip_c_comments(f.read())
    out = []
    base = os.path.basename(path)
    for name, line, body in _c_launchers(src):
        for lineno, text in enumerate(body.splitlines()):
            for call in _BANNED_CUDA_CALLS:
                if call in text:
                    out.append(Finding(
                        rule="TRC001", file=path, line=line + lineno,
                        symbol=f"{base}:{name}",
                        message=f"{call.rstrip('(')} in CUDA launcher "
                                f"{name!r} — a launcher must stay "
                                "asynchronous on the caller's stream "
                                "(it runs inside captures)"))
    return out


def _capture_safe_findings() -> list[Finding]:
    """The bodies a chain's CUDA graph records, via registry
    introspection (the capture-safe set of the torch backend)."""
    from repro_torch.core.backends.torch_backend import (CAPTURE_SAFE,
                                                         TorchBackend)
    out: list[Finding] = []
    be = TorchBackend()
    for (lib, rt) in sorted(CAPTURE_SAFE):
        if not be.supports(lib, rt):
            continue
        impl = be.routine_impl(lib, rt)
        try:
            src = textwrap.dedent(inspect.getsource(impl.fn))
            file = inspect.getsourcefile(impl.fn) or "?"
        except (OSError, TypeError):
            continue
        fndef = ast.parse(src).body[0]
        if not isinstance(fndef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        base_line = inspect.getsourcelines(impl.fn)[1] - 1
        for lineno, what in _impure_nodes(fndef):
            out.append(Finding(
                rule="TRC001", file=file, line=base_line + lineno,
                symbol=f"{lib}.{rt}@capture",
                message=f"{what} inside the capture-safe impl of "
                        f"{lib}.{rt} — its body is recorded into a "
                        "chain's CUDA graph and must stay on the device"))
    return out


def check_trace_purity(paths: Optional[list[str]] = None,
                       cu_paths: Optional[list[str]] = None,
                       include_capture_safe: bool = True
                       ) -> list[Finding]:
    """TRC001 over ``paths`` (every function: wrappers and launch
    modules), the ``extern "C"`` launchers of ``cu_paths`` and, with
    ``include_capture_safe``, the capture-safe registry."""
    if paths is None:
        paths = _launch_files()
    if cu_paths is None:
        cu_paths = _cu_files()
    out: list[Finding] = []
    for p in paths:
        out.extend(_scan_file_for_trace_purity(p))
    for p in cu_paths:
        out.extend(_scan_cu_for_trace_purity(p))
    if include_capture_safe:
        out.extend(_capture_safe_findings())
    # one finding per (site, message-kind): a wrapper reached both by the
    # file scan and the registry scan reports once
    seen: set[str] = set()
    deduped = []
    for f in out:
        key = f"{f.file}:{f.line}:{f.message}"
        if key not in seen:
            seen.add(key)
            deduped.append(f)
    return deduped


# ---- PKL001: no pickle on the wire ------------------------------------
_PICKLE_MODULES = frozenset({
    "pickle", "cPickle", "_pickle", "dill", "cloudpickle", "marshal",
    "shelve",
})


def check_no_pickle(paths: Optional[list[str]] = None) -> list[Finding]:
    if paths is None:
        paths = [_core_path(n) for n in
                 ("wire.py", "transfer.py", "protocol.py", "server.py")]
    out: list[Finding] = []
    for path in paths:
        with open(path, "r") as f:
            tree = ast.parse(f.read())
        base = os.path.basename(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    root = alias.name.split(".")[0]
                    if root in _PICKLE_MODULES:
                        out.append(Finding(
                            rule="PKL001", file=path, line=node.lineno,
                            symbol=f"{base}:import-{root}",
                            message=f"import {alias.name} in a wire-"
                                    "data module — user data must stay "
                                    "on raw tobytes/msgpack (a pickle "
                                    "deserializer is remote code "
                                    "execution)"))
            elif isinstance(node, ast.ImportFrom):
                root = (node.module or "").split(".")[0]
                if root in _PICKLE_MODULES:
                    out.append(Finding(
                        rule="PKL001", file=path, line=node.lineno,
                        symbol=f"{base}:import-{root}",
                        message=f"from {node.module} import ... in a "
                                "wire-data module — pickle-family "
                                "codecs are banned on user data paths"))
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id in ("eval", "exec"):
                    out.append(Finding(
                        rule="PKL001", file=path, line=node.lineno,
                        symbol=f"{base}:{fn.id}",
                        message=f"{fn.id}() in a wire-data module"))
                elif isinstance(fn, ast.Attribute) \
                        and isinstance(fn.value, ast.Name) \
                        and fn.value.id in _PICKLE_MODULES:
                    out.append(Finding(
                        rule="PKL001", file=path, line=node.lineno,
                        symbol=f"{base}:{fn.value.id}.{fn.attr}",
                        message=f"{fn.value.id}.{fn.attr}() in a "
                                "wire-data module"))
    return out


# ---- LCK001: raw-lock discipline --------------------------------------
_RAW_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                             "BoundedSemaphore"})


def check_lock_discipline(paths: Optional[list[str]] = None
                          ) -> list[Finding]:
    if paths is None:
        paths = _py_files(_core_path()) + _py_files(_pkg_path("kernels"))
    out: list[Finding] = []
    for path in paths:
        with open(path, "r") as f:
            tree = ast.parse(f.read())
        base = os.path.basename(path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "threading" \
                    and fn.attr in _RAW_LOCK_CTORS:
                out.append(Finding(
                    rule="LCK001", file=path, line=node.lineno,
                    symbol=f"{base}:threading.{fn.attr}",
                    message=f"raw threading.{fn.attr}() in core or "
                            "kernels — construct locks through "
                            "repro_torch.analysis.locktrace (make_lock/"
                            "make_rlock/"
                            "make_condition) so the lock-order "
                            "detector sees every lock in the process"))
    return out


# ---- LCK002: rank-table integrity (code + docs) ------------------------
_RANK_TABLE_BEGIN = "<!-- LOCK_RANK_TABLE_BEGIN -->"
_RANK_TABLE_END = "<!-- LOCK_RANK_TABLE_END -->"


def _default_doc_path() -> str:
    root = os.path.dirname(_repo_src())         # .../src -> repo root
    return os.path.join(root, "docs", "torch_architecture.md")


def _parse_rank_table(text: str, path: str
                      ) -> tuple[Optional[dict[str, int]], list[Finding]]:
    """lock name -> documented rank, read from the marked table rows
    (``| <rank> | `name` | prose |``)."""
    try:
        begin = text.index(_RANK_TABLE_BEGIN)
        end = text.index(_RANK_TABLE_END)
    except ValueError:
        return None, [Finding(
            rule="LCK002", file=path, line=1,
            symbol="docs:rank-table-markers",
            message=f"docs/torch_architecture.md lacks the "
                    f"{_RANK_TABLE_BEGIN} / {_RANK_TABLE_END} markers "
                    "around the lock rank table — LCK002 cannot check "
                    "docs against code")]
    out: dict[str, int] = {}
    findings: list[Finding] = []
    base_line = text[:begin].count("\n") + 1
    for i, line in enumerate(text[begin:end].splitlines()):
        row = line.strip()
        if not row.startswith("|") or set(row) <= {"|", "-", " "}:
            continue
        cells = [c.strip() for c in row.strip("|").split("|")]
        if len(cells) < 2 or cells[0] in ("rank", ""):
            continue
        m = None
        if cells[1].startswith("`") and cells[1].endswith("`"):
            m = cells[1].strip("`")
        try:
            rank = int(cells[0])
        except ValueError:
            rank = None
        if m is None or rank is None:
            findings.append(Finding(
                rule="LCK002", file=path, line=base_line + i,
                symbol=f"docs:rank-row:{cells[1][:40]}",
                message=f"unparseable rank-table row {row!r} — expected "
                        "`| <int rank> | `lock.name` | prose |`"))
            continue
        out[m] = rank
    return out, findings


def check_lock_ranks(ranks: Optional[dict[str, int]] = None,
                     doc_path: Optional[str] = None) -> list[Finding]:
    """LCK002: unique ranks in code, and docs == code."""
    from repro_torch.analysis.locktrace import LOCK_RANKS
    if ranks is None:
        ranks = LOCK_RANKS
    if doc_path is None:
        doc_path = _default_doc_path()
    out: list[Finding] = []
    code_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "locktrace.py")
    by_rank: dict[int, list[str]] = {}
    for name, rank in ranks.items():
        by_rank.setdefault(rank, []).append(name)
    for rank, names in sorted(by_rank.items()):
        if len(names) > 1:
            out.append(Finding(
                rule="LCK002", file=code_file, line=1,
                symbol=f"rank-dup:{rank}",
                message=f"locks {sorted(names)} share rank {rank} — "
                        "ranks must be unique so LOCK_RANKS is a total "
                        "order (equal-rank nesting is undetectable)"))
    try:
        with open(doc_path, "r") as f:
            text = f.read()
    except OSError:
        return out + [Finding(
            rule="LCK002", file=doc_path, line=1,
            symbol="docs:missing",
            message="docs/torch_architecture.md not found — the "
                    "documented lock order cannot be checked")]
    documented, findings = _parse_rank_table(text, doc_path)
    out.extend(findings)
    if documented is None:
        return out
    for name in sorted(set(ranks) - set(documented)):
        out.append(Finding(
            rule="LCK002", file=doc_path, line=1,
            symbol=f"docs:undocumented:{name}",
            message=f"lock {name!r} (rank {ranks[name]}) is registered "
                    "in locktrace.LOCK_RANKS but missing from the "
                    "documented rank table"))
    for name in sorted(set(documented) - set(ranks)):
        out.append(Finding(
            rule="LCK002", file=doc_path, line=1,
            symbol=f"docs:stale:{name}",
            message=f"documented lock {name!r} is not registered in "
                    "locktrace.LOCK_RANKS — stale docs row"))
    for name in sorted(set(documented) & set(ranks)):
        if documented[name] != ranks[name]:
            out.append(Finding(
                rule="LCK002", file=doc_path, line=1,
                symbol=f"docs:rank-drift:{name}",
                message=f"documented rank {documented[name]} for "
                        f"{name!r} != code rank {ranks[name]}"))
    return out
