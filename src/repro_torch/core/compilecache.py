"""The compile-latency subsystem: shape buckets + a persistent
executable index.

The paper's offload argument only holds while the overheads *around* the
fast kernel stay small (Gittens et al., KDD 2018; the 2019 Spark-on-HPC
benchmarking follow-up makes the same point about latency hiding). Our
engine fuses whole lazy chains into single ``jax.jit`` programs, but
every new (chain structure x operand shape) pays the full XLA
trace+compile on the critical path of the first call that exhibits it —
and the compiled-program cache dies with the process. Under a
shape-diverse multi-tenant mix that is a p99 killer: every tenant's
first submission of a new shape stalls behind a compile.

Three coordinated pieces (the maxtext serving idiom — AOT
``lower().compile()`` + bucketed shapes + explicit warmup — applied to
the Alchemist engine):

* :class:`BucketPolicy` — pad operand shapes up to a small configurable
  grid of bucket sizes, so diverse tenant shapes collapse onto a handful
  of compiled executables. Only routines whose implementations declare
  ``bucketable`` (zero-padding provably preserved: the logical block of
  the padded result equals the unpadded result, and pad regions stay
  zero through chains) are eligible; everything else runs at its exact
  shape. :func:`propagate_shapes` runs the per-routine shape rules
  through a plan so outputs can be cropped back to their logical shapes.
* **AOT warmup** — the engine pre-compiles cataloged bucketable routines
  (and every signature in the executable index, which is how *hot chain
  signatures* register themselves) for the bucket grid via
  ``jax.jit(...).lower(ShapeDtypeStruct...).compile()``, off the request
  path (``AlchemistEngine.warmup`` / ``warmup_on_load``): the first
  tenant to submit a bucketed shape never sees a trace. In the PyTorch
  port "AOT" means built from the plan's specs before any request: a run
  at the spec's shapes, or a CUDA graph captured on static input buffers
  (``TorchBackend.get_or_compile``).
* **Persistence** — :class:`ExecutableIndex` records every plan built
  ahead of its request (structure + input specs), so a restarted engine
  can rebuild exactly the programs it served before. In the PyTorch port
  the index is all that persists: a program (a CUDA graph, or a run at
  the spec's shapes) dies with its process, and a warm restart rebuilds
  each in ``warmup`` before traffic. There is no disk cache of programs.

``costmodel.CompileLog`` is the observability surface: traces, AOT vs
on-demand, bucket hit-rate, and compile seconds on/off the request path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Iterable, Optional

try:                                    # posix: advisory file locking for
    import fcntl                        # cross-process index merges
except ImportError:                     # pragma: no cover - non-posix
    fcntl = None

from repro_torch.analysis import locktrace

from repro_torch.core.backends import base as backend_base

# Default bucket grid: powers of two spanning the shapes this repo's
# workloads actually submit. Power-of-two buckets mean the existing
# pow2-shaped suites pad by zero bytes (exact fit) while odd tenant
# shapes collapse onto ~log(range) compiled programs per routine.
DEFAULT_BUCKET_GRID = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

# Default warmup grid: the subset of buckets pre-compiled at
# load_library time. Deliberately small — warmup cost is
# O(grid^matrix_params) programs per routine; request-path traffic on
# other buckets still compiles once per bucket and is then recorded in
# the executable index, so the *next* warmup covers it.
DEFAULT_WARMUP_GRID = (256, 1024)

# Ceiling on enumerated shape combinations per routine during catalog
# warmup (multiply is cubic in the grid length).
WARMUP_COMBOS_PER_ROUTINE = 64

# The largest operand catalog warmup can make, the largest default bucket
# squared in fp32 (256 MiB): the torch backend copies an input slot up to
# this size into a program's static buffers, or runs it on zeros at
# compile time; a larger one is read in place.
SMALL_SLOT_BYTES = max(DEFAULT_BUCKET_GRID) ** 2 * 4


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Shape-bucketing policy: every dimension is padded up to the
    smallest grid entry that holds it; dimensions beyond the largest
    bucket pass through unpadded (still compiled+cached, keyed by their
    exact shape — just never collapsed).

    ``enabled=False`` makes every ``bucket_*`` an identity, so one code
    path serves both configurations.
    """
    grid: tuple[int, ...] = DEFAULT_BUCKET_GRID
    enabled: bool = True

    def __post_init__(self):
        g = tuple(sorted(int(b) for b in self.grid))
        if any(b <= 0 for b in g):
            raise ValueError(f"bucket grid must be positive, got {g}")
        object.__setattr__(self, "grid", g)

    def bucket_dim(self, n: int) -> int:
        """Smallest bucket >= n, or n itself beyond the grid."""
        if not self.enabled:
            return int(n)
        for b in self.grid:
            if b >= n:
                return b
        return int(n)

    def bucket_shape(self, shape) -> tuple[int, ...]:
        return tuple(self.bucket_dim(int(d)) for d in shape)

    def is_exact(self, shape) -> bool:
        """True when bucketing would pad nothing (zero-copy fast case)."""
        return tuple(int(d) for d in shape) == self.bucket_shape(shape)


# ---------------------------------------------------------------------------
# plan shape propagation (the crop-back contract)
# ---------------------------------------------------------------------------
def plan_bucketable(plan: backend_base.ExecutionPlan) -> bool:
    """A plan may run on padded operands only when *every* step's
    implementation declares ``bucketable`` (zero pad regions provably
    flow through to zero pad regions) and carries a shape rule to crop
    outputs back with."""
    return all(
        s.impl.kind == backend_base.ARRAY and s.impl.bucketable
        and s.impl.out_shapes is not None
        for s in plan.steps)


def propagate_shapes(plan: backend_base.ExecutionPlan,
                     input_shapes: dict[str, tuple]
                     ) -> Optional[list[dict[str, tuple]]]:
    """Run every step's declared shape rule over the plan, resolving
    ``Input``/``StepRef`` placeholders to shapes, and return the
    per-step output-shape dicts — what the engine crops padded program
    outputs back to. ``None`` when a step has no rule or a rule rejects
    the shapes (the caller falls back to exact-shape execution, where
    the real implementation raises the real error)."""
    per_step: list[dict[str, tuple]] = []
    for step in plan.steps:
        shapes: dict[str, tuple] = {}
        scalars: dict[str, Any] = {}
        try:
            for k, v in step.args.items():
                if isinstance(v, backend_base.Input):
                    shapes[k] = tuple(input_shapes[v.slot])
                elif isinstance(v, backend_base.StepRef):
                    shapes[k] = tuple(per_step[v.step][v.key])
                else:
                    scalars[k] = v
            rule = step.impl.out_shapes
            if rule is None:
                return None
            per_step.append({k: tuple(s)
                             for k, s in rule(shapes, **scalars).items()})
        except Exception:
            return None
    return per_step


# ---------------------------------------------------------------------------
# serializable plan signatures (the engine-level executable index)
# ---------------------------------------------------------------------------
def signature_key(backend: str, signature) -> str:
    """Stable content key for one compiled program: backend name + the
    plan's shape-aware signature (nested tuples of scalars — ``repr`` is
    deterministic for those)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(backend.encode())
    h.update(b"|")
    h.update(repr(signature).encode())
    return h.hexdigest()


def _encode_arg(v):
    if isinstance(v, backend_base.Input):
        return {"__kind__": "input", "slot": v.slot}
    if isinstance(v, backend_base.StepRef):
        return {"__kind__": "stepref", "step": v.step, "key": v.key}
    if isinstance(v, tuple):
        return {"__kind__": "tuple", "items": [_encode_arg(x) for x in v]}
    return v


def _decode_arg(v):
    if isinstance(v, dict) and "__kind__" in v:
        if v["__kind__"] == "input":
            return backend_base.Input(v["slot"])
        if v["__kind__"] == "stepref":
            return backend_base.StepRef(v["step"], v["key"])
        if v["__kind__"] == "tuple":
            return tuple(_decode_arg(x) for x in v["items"])
    return v


def plan_record(backend: str, plan: backend_base.ExecutionPlan,
                compile_s: float = 0.0) -> Optional[dict]:
    """Serialize one compiled plan for the executable index, or None for
    plans that cannot round-trip (unhashable/unserializable args — those
    were never program-cached anyway)."""
    sig = plan.signature()
    if sig is None or plan.input_specs is None:
        return None
    rec = {
        "key": signature_key(backend, sig),
        "backend": backend,
        "label": plan_label(plan),
        "steps": [{"library": s.library, "routine": s.routine,
                   "args": {k: _encode_arg(v) for k, v in s.args.items()}}
                  for s in plan.steps],
        "input_specs": {slot: [list(shape), dtype]
                        for slot, (shape, dtype) in plan.input_specs.items()},
        "compile_s": round(float(compile_s), 6),
    }
    try:
        json.dumps(rec)
    except (TypeError, ValueError):
        return None
    return rec


def plan_from_record(rec: dict, backend: backend_base.ExecutionBackend
                     ) -> Optional[backend_base.ExecutionPlan]:
    """Rebuild an :class:`ExecutionPlan` from an index record against a
    live backend (implementations are looked up fresh — a record whose
    routine is no longer registered is skipped, not an error)."""
    try:
        steps = []
        for s in rec["steps"]:
            if not backend.supports(s["library"], s["routine"]):
                return None
            impl = backend.routine_impl(s["library"], s["routine"])
            steps.append(backend_base.PlanStep(
                library=s["library"], routine=s["routine"],
                args={k: _decode_arg(v) for k, v in s["args"].items()},
                impl=impl))
        specs = {slot: (tuple(int(d) for d in shape), str(dtype))
                 for slot, (shape, dtype) in rec["input_specs"].items()}
        return backend_base.ExecutionPlan(steps=steps, input_specs=specs)
    except Exception:
        return None


def plan_label(plan: backend_base.ExecutionPlan) -> str:
    """Human label for logs: the step routines, elided past 3."""
    names = [f"{s.library}.{s.routine}" for s in plan.steps]
    if len(names) > 3:
        return "+".join(names[:3]) + f"+{len(names) - 3}more"
    return "+".join(names)


class ExecutableIndex:
    """The engine-level index over the persistent compilation cache.

    One JSON file per cache dir mapping signature keys to replayable
    plan records. Every program the engine builds ahead of execution —
    in warmup *or* on the request path — is recorded here, which is how
    hot chain signatures "register" themselves: a restarted engine's
    warmup replays every record (rebuilding each program: a run at its
    shapes, or a capture) and tenant traffic then finds every
    previously-served program already built.

    Writes are atomic (tmp + rename), thread-lock-protected in process,
    and **merge-on-write** across processes: each save takes an exclusive
    ``flock`` on a sidecar lockfile, reloads whatever is on disk, unions
    it with the in-memory records, and writes the union — so two engines
    sharing a cache dir each keep the other's recordings instead of
    last-write-winning the whole file. Re-recording a known key is a
    no-op.
    """

    FILENAME = "executables.json"
    LOCKNAME = "executables.json.lock"

    def __init__(self, cache_dir: str):
        self.path = os.path.join(cache_dir, self.FILENAME)
        self.lock_path = os.path.join(cache_dir, self.LOCKNAME)
        self._lock = locktrace.make_lock("compilecache.index")
        self._records: dict[str, dict] = {}
        self._load()

    def _read_disk(self) -> dict:
        try:
            with open(self.path, "rb") as f:
                data = json.load(f)
            if isinstance(data, dict):
                return {k: v for k, v in data.items()
                        if isinstance(v, dict)}
        except (OSError, ValueError):
            pass
        return {}

    def _load(self) -> None:
        self._records = self._read_disk()

    def _flock(self):
        """Exclusive cross-process lock on the sidecar file, or None when
        the platform has no flock (then writes fall back to plain atomic
        replace — still uncorrupted, merely last-write-wins)."""
        if fcntl is None:               # pragma: no cover - non-posix
            return None
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except OSError:                 # pragma: no cover - exotic fs
            os.close(fd)
            return None
        return fd

    def _save_locked(self) -> None:
        # merge-on-write: under the cross-process flock, fold the on-disk
        # records (another engine may have grown them since our last
        # load) into ours, then atomically replace with the union. Our
        # in-memory copy wins ties — keys are content-addressed, so a tie
        # is the same plan anyway.
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        lock_fd = self._flock()
        try:
            for key, rec in self._read_disk().items():
                self._records.setdefault(key, rec)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self.path) or ".",
                prefix=".executables.")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(self._records, f, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        finally:
            if lock_fd is not None:
                try:
                    fcntl.flock(lock_fd, fcntl.LOCK_UN)
                finally:
                    os.close(lock_fd)

    def record(self, backend: str, plan: backend_base.ExecutionPlan,
               compile_s: float = 0.0) -> bool:
        """Record one compiled plan; returns True when the index grew."""
        rec = plan_record(backend, plan, compile_s)
        if rec is None:
            return False
        with self._lock:
            if rec["key"] in self._records:
                return False
            self._records[rec["key"]] = rec
            self._save_locked()
            return True

    def entries(self, backend: Optional[str] = None) -> list[dict]:
        """Every recorded plan (optionally one backend's), stable order."""
        with self._lock:
            recs = sorted(self._records.values(),
                          key=lambda r: (r.get("label", ""), r.get("key")))
        if backend is None:
            return recs
        return [r for r in recs if r.get("backend") == backend]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


# ---------------------------------------------------------------------------
# catalog warmup enumeration
# ---------------------------------------------------------------------------
def matrix_params_of(impl: backend_base.RoutineImpl) -> list[str]:
    """Which parameters a routine's shape rule treats as matrices,
    discovered by probing: the rule reads ``shapes[param]`` for exactly
    its matrix operands (``shapes_multiply`` touches A and B,
    ``shapes_gram`` only A), so a recording dict observes them without
    any schema to keep in sync."""
    if impl.out_shapes is None:
        return []
    seen: set[str] = set()

    class _Probe(dict):
        def __getitem__(self, key):
            seen.add(key)
            return (4, 4)

        def __contains__(self, key):
            seen.add(key)
            return True

    try:
        impl.out_shapes(_Probe())
    except Exception:
        pass
    return sorted(seen)


def warmup_shape_sets(impl: backend_base.RoutineImpl,
                      matrix_params: list[str],
                      grid: Iterable[int],
                      limit: int = WARMUP_COMBOS_PER_ROUTINE
                      ) -> list[dict[str, tuple]]:
    """Enumerate per-matrix (rows, cols) assignments from ``grid`` that
    the routine's shape rule accepts — the bucket combinations catalog
    warmup AOT-compiles. The rule itself is the validity filter: multiply
    keeps only combos whose contracted dims agree, add only equal
    shapes, so the enumeration never compiles a program no bucketed
    request could hit."""
    if impl.out_shapes is None or not matrix_params:
        return []
    dims = tuple(sorted({int(g) for g in grid}))
    shapes_one = [(r, c) for r in dims for c in dims]
    combos: list[dict[str, tuple]] = []

    def rec(i: int, acc: dict[str, tuple]):
        if len(combos) >= limit:
            return
        if i == len(matrix_params):
            try:
                impl.out_shapes(dict(acc))
            except Exception:
                return
            combos.append(dict(acc))
            return
        for sh in shapes_one:
            acc[matrix_params[i]] = sh
            rec(i + 1, acc)
            del acc[matrix_params[i]]

    rec(0, {})
    return combos
