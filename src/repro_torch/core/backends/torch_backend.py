"""The PyTorch backend — the port's counterpart of the JAX package's
``jax_backend.py``, and the engine's default execution environment.

Implementations are tensor-level: torch tensors in, torch tensors out, on
whatever device the engine keeps its stores (one CUDA device, or the CPU
when a caller asks for it). Three routines go through the port's
hand-written kernels (``repro_torch/kernels``):

* ``gram`` and ``gram_svd`` through ``gram``;
* ``cg_solve``'s iteration through ``normal_matvec``;
* ``cg_solve``'s ``rf_dim`` expansion and ``random_features`` through
  ``rf_map``.

**``use_pallas`` selects nothing here.** The parameter stays in every
routine signature and library catalog, so the wire catalogs are
byte-identical to the JAX package's; in the port the *device* decides: a
CUDA tensor always launches the CUDA kernel, a CPU tensor always takes
the kernel's plain PyTorch version. There is no fallback between them.

Random values (``random_matrix``, ``random_features``, the ``rf_dim``
expansion, the Lanczos start vector, ``randomized_svd``'s sketch,
``nmf``'s init) are drawn with numpy's ``default_rng(seed)`` exactly as
the reference backend draws them, so the two agree bit for bit on what
they draw (the JAX backend's threefry draws agree in distribution only).

**Chain fusion.** The backend fuses (``supports_fusion = True``): when
the engine claims a dependency chain a lazy client submitted in one
burst (``scheduler.claim_chain``, ``engine._run_fused``), the whole
multi-step plan runs as one task, its intermediates never leaving the
engine.

**The program cache** (``supports_aot = True``). The engine compiles
every fused chain and every bucketed single op through
:meth:`TorchBackend.get_or_compile`, keyed by ``plan.signature()`` (the
plan's structure, scalars and ``input_specs``: shapes and dtypes) in one
LRU bounded by count (``max_programs``) and by the device bytes the
programs hold (``max_program_bytes``), and pads and crops bucketed
operands with :meth:`~TorchBackend.pad_to` and
:meth:`~TorchBackend.crop_to`. How a program is built is decided from
the plan and its specs alone, before any request, by the size of each
input slot: a slot is **small** up to
:data:`~repro_torch.core.compilecache.SMALL_SLOT_BYTES` (the largest
operand catalog warmup makes, the largest bucket squared in fp32), else
**large**, and a large slot is read in place, never copied.

* a single-step plan is an **eager program** that holds no buffers.
  Compiling it runs it once at the spec's shapes on zero tensors (on the
  backend's side stream on a card), which loads the kernels' modules,
  settles cuBLAS and grows the allocator before any request does;
* a multi-step plan that is :meth:`~TorchBackend.capturable`, on a card,
  with every slot small, gets **static input buffers** at the spec's
  shapes and is captured into one **CUDA graph** reading them (an eager
  warm-up run first, then the capture, on the side stream). ``aot`` is
  true: warmup and a warm restart capture it before traffic, and a
  replay copies its inputs into the buffers first, so a padded input (a
  fresh tensor at every call) replays too;
* a capturable plan on a card with a large slot (or no specs) keeps
  one capture per input address: its program captures on first use for
  each (shape, stride, dtype, address) of its inputs (:func:`program_key`,
  the same LRU), and its ``aot`` is false, since nothing can be captured
  without the tensor;
* every other plan (``qr``, ``gram_svd`` and ``random_matrix`` refuse
  capture: the first hands back a CPU tensor drawn on the host, the
  others check LAPACK's info on the host), and every plan on the CPU, is
  an eager program: the same key, LRU and accounting, never a graph,
  run once at the spec's shapes when its slots are small. ``aot`` then
  means "built from its specs before any request".

A capture runs on a side stream in ``thread_local`` mode, so other
workers go on launching, copying, allocating and synchronising their
own streams meanwhile. Two things of theirs still collide with it: a
device-wide ``torch.cuda.synchronize`` (it fails, and invalidates the
capture; the engine waits on its worker's stream instead, and nothing
on the compile path synchronises more than a stream or an event), and a
draw from the default CUDA generator (PyTorch registers that generator
with every capture); the engine's routines draw on the host. A capture
that fails counts in ``capture_failures`` and nothing is kept.

Host-loop solvers (Lanczos SVD, CG, NMF) are reverse-communication
loops around device products, as in the JAX backend, and are never
fused.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import locktrace
from repro_torch.core import compilecache
from repro_torch.core.backends import base
from repro_torch.core.backends.base import REPLICATED, ROWBLOCK
from repro_torch.core.backends.reference import (
    _lanczos_gram,
    mllib_cg_solve,
    mllib_truncated_svd,
)
from repro_torch.kernels import device as kernel_device
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.normal_matvec import ops as nm_ops
from repro_torch.kernels.rf_map import ops as rf_ops

_DENSE = (ROWBLOCK, REPLICATED)

#: default bound on programs held live (LRU), as the JAX backend bounds
#: its compiled programs
DEFAULT_MAX_PROGRAMS = 128

#: default bound on the device bytes live programs hold, as a share of the
#: card's memory. A program with static buffers pins its inputs and every
#: step's outputs (up to 256 MiB a slot), where the JAX backend's compiled
#: executables pin no argument buffers: at the count bound alone, 128
#: two-input two-step chains at the 8,192 bucket would pin ~128 GiB. A
#: quarter (~20 GB of an 80 GB card) keeps about twenty such chains hot
#: and leaves three quarters to the stores, which the engine's memory
#: budget governs, and to the routines' working memory
PROGRAM_MEMORY_SHARE = 0.25

#: the routines whose implementation here may be captured into a CUDA
#: graph: device work only, on the current stream, with no host
#: synchronisation and no copy from pageable memory
CAPTURE_SAFE = frozenset(("elemental", r) for r in (
    "multiply", "add", "transpose", "gram", "replicate_cols"))


def spec_dtype(name: str) -> torch.dtype:
    """The torch dtype an ``input_specs`` dtype string names
    (``"float32"``, as the engine and the JAX package write it)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in input_specs")
    return dt


def slot_bytes(shape, dtype: str) -> int:
    """Bytes of one input slot of ``shape`` and ``dtype``."""
    return math.prod(int(d) for d in shape) * spec_dtype(dtype).itemsize


def small_slots(plan: base.ExecutionPlan) -> bool:
    """Whether the plan has specs and every input slot is small (at most
    :data:`compilecache.SMALL_SLOT_BYTES`): what a program may copy into
    buffers of its own or run on zeros at compile time. A large slot is
    read in place."""
    return plan.input_specs is not None and all(
        slot_bytes(shape, dt) <= compilecache.SMALL_SLOT_BYTES
        for shape, dt in plan.input_specs.values())


def program_key(plan: base.ExecutionPlan,
                inputs: dict) -> Optional[tuple]:
    """The key of a capture made for one set of input addresses: the
    plan's signature plus, for each input, its shape, stride, dtype,
    device and address. A CUDA graph reads its inputs where they lay at
    capture, so a replay is right for any tensor at that address with
    that shape, stride and dtype, and a new address is a new capture.
    Programs with a large slot key their captures so (their inputs are
    never copied). ``None`` when an argument is unhashable."""
    sig = plan.signature()
    if sig is None:
        return None
    return sig, tuple(sorted(
        (slot, tuple(t.shape), tuple(t.stride()), str(t.dtype),
         str(t.device), t.data_ptr()) for slot, t in inputs.items()))


def _interpret(plan: base.ExecutionPlan, inputs: dict) -> list[dict]:
    """Every step of the plan in order, nothing between them: the body a
    capture records and a compile-time run executes."""
    outs: list[dict] = []
    for step in plan.steps:
        outs.append(step.impl.fn(**base.resolve_step_args(step, outs,
                                                          inputs)))
    return outs


def _tensor_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen: dict[int, int] = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


class _Eager:
    """An eager program: the plan's steps on the current stream, holding
    nothing on the device."""

    graph = None
    nbytes = 0

    def __init__(self, run):
        self._run = run

    def __call__(self, inputs: dict) -> list[dict]:
        return self._run({k: v if isinstance(v, torch.Tensor)
                          else torch.as_tensor(v)
                          for k, v in inputs.items()})

    def release(self) -> None:
        pass


class _ByAddress:
    """A capturable program with a large slot (or no specs): one capture
    per input address, each an entry of the backend's LRU under
    :func:`program_key`; inputs off the card run eagerly. Holds nothing
    itself."""

    graph = None
    nbytes = 0

    def __init__(self, backend: "TorchBackend", plan: base.ExecutionPlan,
                 eager):
        self._backend, self._plan, self._eager = backend, plan, eager

    def __call__(self, inputs: dict) -> list[dict]:
        if not inputs or not all(isinstance(t, torch.Tensor) and t.is_cuda
                                 for t in inputs.values()):
            return self._eager(inputs)
        return self._backend._run_graph(self._plan, self._eager, inputs)

    def release(self) -> None:
        pass


class _Program:
    """One captured plan: its CUDA graph, the outputs the graph writes at
    every replay (in the graph's private memory pool), the kernel launches
    its capture recorded and, for a program with static input buffers,
    the buffers the graph reads (``buffers``; empty when the graph reads
    its inputs where they lay at capture)."""

    def __init__(self, graph, outs: list[dict], launches: dict,
                 plan: Optional[base.ExecutionPlan] = None,
                 buffers: Optional[dict] = None, ready=None):
        self.graph = graph
        self.outs = outs
        self.launches = launches
        self.plan = plan
        self.buffers = buffers or {}
        self.lock = locktrace.make_lock("backend.program")
        self.done = ready       # event after the last replay's copies

    @property
    def nbytes(self) -> int:
        """Device bytes the program holds: its buffers and outputs."""
        with self.lock:
            if self.graph is None:
                return 0
            return _tensor_bytes([*self.buffers.values()] +
                                 [v for step in self.outs
                                  for v in step.values()])

    def __call__(self, inputs: dict) -> list[dict]:
        """Run a program with static buffers on ``inputs``."""
        outs = self.replay(inputs)
        if outs is None:
            # released by the LRU since the engine looked it up: this call
            # runs its steps on the current stream
            return _interpret(self.plan, inputs)
        return outs

    def replay(self, inputs: Optional[dict] = None
               ) -> Optional[list[dict]]:
        """Copy ``inputs`` into the buffers, replay on the current stream
        and hand out copies of the outputs: the next replay overwrites the
        graph's own. The lock keeps a second worker from overwriting the
        buffers or the outputs before they are read; ``done`` orders a
        replay on another stream after the last one's copies. ``None``
        once the program was released."""
        with self.lock:
            if self.graph is None:
                return None
            stream = torch.cuda.current_stream()
            if self.done is not None:
                stream.wait_event(self.done)
            for slot, buf in self.buffers.items():
                buf.copy_(inputs[slot])
            self.graph.replay()
            outs = [{k: v.clone(memory_format=torch.contiguous_format)
                     if isinstance(v, torch.Tensor) else v
                     for k, v in step.items()} for step in self.outs]
            self.done = torch.cuda.Event()
            self.done.record(stream)
            # a replay launches what the capture recorded, uncounted there
            for counter, n in self.launches.items():
                counter.add(n)
            return outs

    def release(self) -> None:
        """Drop the graph, its outputs and its buffers, returning its
        pool and their memory."""
        with self.lock:
            if self.graph is None:
                return
            if self.done is not None:
                self.done.synchronize()
            self.graph.reset()
            self.graph = self.outs = None
            self.buffers = {}


class TorchBackend(base.ExecutionBackend):
    """PyTorch execution on the engine's device (``device``, set by the
    engine); a burst chain runs as one task, replayed from a CUDA graph on
    a card where every step allows capture.

    Programs are held in an LRU keyed by plan signature (see the module's
    docstring for how each is built), bounded by count (``max_programs``)
    and by the device bytes they hold (``max_program_bytes``; ``None``,
    the default, is :data:`PROGRAM_MEMORY_SHARE` of the device's memory on
    a card, and no bound on the CPU, where programs hold nothing): the
    oldest go first while either bound is passed, never the newest, so a
    program larger than the byte bound stays alone until the next.
    Beside :meth:`program_cache_info`: ``capture_failures`` counts
    captures that failed on the card (nothing is kept; on the request
    path the call is answered eagerly), which no run should see;
    ``capture_seconds`` the seconds of the captures kept; :meth:`graphs`
    the captured graphs held and :meth:`held_bytes` the device bytes the
    programs hold."""

    name = "torch"
    supports_fusion = True
    #: programs are built from ``input_specs`` before any request (run
    #: once at those shapes, or captured): what warmup and bucketing key
    #: off
    supports_aot = True

    def __init__(self, max_programs: int = DEFAULT_MAX_PROGRAMS,
                 max_program_bytes: Optional[int] = None):
        super().__init__()
        self._programs: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._programs_lock = locktrace.make_lock("backend.programs")
        # one build or capture at a time, on this backend's side stream
        self._capture_lock = locktrace.make_lock("backend.capture")
        self._side_stream = None
        #: the engine's device, where compile-time runs and buffers go
        self.device = torch.device("cpu")
        #: bound on live programs (the engine's ``program_cache_size``)
        self.max_programs = int(max_programs)
        #: bound on the device bytes live programs hold; ``None``: the
        #: device's share (:meth:`program_bytes_bound`)
        self.max_program_bytes = None if max_program_bytes is None \
            else int(max_program_bytes)
        #: programs dropped by the LRU bound since construction
        self.evictions = 0
        #: captures that raised on the card (nothing kept)
        self.capture_failures = 0
        #: seconds spent capturing programs that were kept
        self.capture_seconds = 0.0

    def to_native(self, array) -> torch.Tensor:
        return array if isinstance(array, torch.Tensor) \
            else torch.as_tensor(array)

    def is_array(self, value) -> bool:
        return isinstance(value, (torch.Tensor, np.ndarray)) and \
            value.ndim >= 1

    # ---- bucket pad/unpad (the shape-collapse wrappers) -----------------
    def pad_to(self, array, shape) -> torch.Tensor:
        """Zero-pad an operand up to its bucket shape (trailing edge of
        every dimension), as the JAX backend's ``pad_to``: for the
        bucketable linear routines the logical block of the padded result
        equals the unpadded result, and pad regions stay zero through
        chains. A fresh tensor whenever it pads."""
        arr = self.to_native(array)
        target = tuple(int(d) for d in shape)
        if tuple(arr.shape) == target:
            return arr
        if len(target) != arr.ndim or \
                any(t < s for t, s in zip(target, arr.shape)):
            raise ValueError(
                f"cannot pad {tuple(arr.shape)} up to {target}")
        out = arr.new_zeros(target)
        out[tuple(slice(0, s) for s in arr.shape)] = arr
        return out

    def crop_to(self, array, shape):
        """Slice a padded program output back to its logical shape, as a
        tensor of its own (a view would keep the padded one alive)."""
        target = tuple(int(d) for d in shape)
        if tuple(array.shape) == target:
            return array
        return self.to_native(array)[tuple(slice(0, d) for d in target)] \
            .clone(memory_format=torch.contiguous_format)

    # ---- chain fusion and the program cache -----------------------------
    def capturable(self, plan: base.ExecutionPlan) -> bool:
        """Whether ``plan`` runs as one CUDA graph on a card: two or more
        steps, each this backend's own implementation of a
        :data:`CAPTURE_SAFE` routine, and a hashable signature. Decided
        from the plan alone, before any launch; a plan that is not
        capturable runs eagerly, still as one task."""
        return len(plan.steps) > 1 and plan.signature() is not None and \
            all((s.library, s.routine) in CAPTURE_SAFE
                and s.impl is self._impls.get((s.library, s.routine))
                for s in plan.steps)

    def compile(self, plan: base.ExecutionPlan):
        """A one-step plan runs its implementation directly; a multi-step
        plan is the cached program :meth:`get_or_compile` builds."""
        if len(plan.steps) == 1:
            return super().compile(plan)
        return self.get_or_compile(plan)[0]

    def get_or_compile(self, plan: base.ExecutionPlan
                       ) -> tuple[object, dict]:
        """The instrumented compile path: ``(program, info)``, where info
        says whether the program came from the cache (``cached``), the
        seconds its build took (``compile_s``: its compile-time run or its
        warm-up and capture), whether it was built from the plan's specs
        before any request (``aot``) and how many programs the LRU dropped
        for it (``evicted``). Keyed by ``plan.signature()``."""
        sig = plan.signature()
        hit = {"cached": True, "compile_s": 0.0, "aot": False, "evicted": 0}
        program = self._cache_get(sig) if sig is not None else None
        if program is not None:
            return program, hit
        with self._capture_lock:
            program = self._cache_get(sig) if sig is not None else None
            if program is not None:
                return program, hit
            t0 = time.perf_counter()
            program, aot, keep = self._build(plan)
            compile_s = time.perf_counter() - t0
        evicted = self._cache_put(sig, program) \
            if sig is not None and keep else 0
        return program, {"cached": False, "compile_s": compile_s,
                         "aot": aot, "evicted": evicted}

    def _build(self, plan: base.ExecutionPlan) -> tuple[object, bool, bool]:
        """Build the program for ``plan`` (the rule in the module's
        docstring), under the capture lock: ``(program, aot, keep)``."""
        eager = super().compile(plan)
        small = small_slots(plan)
        if self.device.type == "cuda" and self.capturable(plan):
            if not small:
                return _ByAddress(self, plan, eager), False, True
            program = self._capture_static(plan)
            if program is None:
                return _Eager(eager), False, False
            return program, True, True
        if small:
            self._run_on_zeros(plan)
        return _Eager(eager), plan.input_specs is not None, True

    def _side(self) -> "torch.cuda.Stream":
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _zeros(self, plan: base.ExecutionPlan) -> dict:
        return {slot: torch.zeros(tuple(shape), dtype=spec_dtype(dt),
                                  device=self.device)
                for slot, (shape, dt) in plan.input_specs.items()}

    def _run_on_zeros(self, plan: base.ExecutionPlan) -> None:
        """Run the plan once at its spec's shapes on zero tensors (on the
        side stream on a card, waiting for that stream only)."""
        if self.device.type != "cuda":
            _interpret(plan, self._zeros(plan))
            return
        side = self._side()
        with torch.cuda.stream(side):
            _interpret(plan, self._zeros(plan))
        side.synchronize()

    def _capture_static(self, plan: base.ExecutionPlan
                        ) -> Optional[_Program]:
        """Static input buffers at the spec's shapes, an eager warm-up run
        on them and the capture reading them, all on the side stream.
        ``None`` when the capture fails (counted)."""
        side = self._side()
        with torch.cuda.stream(side):
            buffers = self._zeros(plan)
            _interpret(plan, buffers)
        return self._record(plan, buffers, side, buffers=buffers)

    def _record(self, plan, inputs: dict, side, buffers=None
                ) -> Optional[_Program]:
        """Capture ``plan`` on ``inputs`` on the side stream in
        ``thread_local`` mode; ``None`` (and one more capture failure)
        when the capture raises."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with kernel_device.capturing_launches() as launches, \
                    torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static = _detached(_interpret(plan, inputs), inputs)
                finally:
                    graph.capture_end()
        except RuntimeError:
            self.capture_failures += 1
            return None
        ready = torch.cuda.Event()
        ready.record(side)
        side.synchronize()
        self.capture_seconds += time.perf_counter() - t0
        return _Program(graph, static, launches, plan=plan,
                        buffers=buffers, ready=ready)

    def _run_graph(self, plan, eager, inputs: dict) -> list[dict]:
        key = program_key(plan, inputs)
        base.yield_check()
        while True:
            program = self._cache_get(key)
            if program is None:
                return self._capture(key, plan, eager, inputs)
            outs = program.replay()
            if outs is not None:
                return outs
            # evicted between the lookup and the replay: capture anew

    def _capture(self, key, plan, eager, inputs: dict) -> list[dict]:
        """Run the plan once eagerly on the side stream, which builds and
        loads the kernels' libraries and sets their launch attributes
        outside the capture and answers this call, then capture it there
        on these very inputs (see the module's docstring for what may
        run meanwhile)."""
        with self._capture_lock:
            if self._cache_get(key) is None:
                return self._capture_locked(key, plan, eager, inputs)
        # another worker captured it meanwhile
        return self._run_graph(plan, eager, inputs)

    def _capture_locked(self, key, plan, eager, inputs: dict) -> list[dict]:
        side = self._side()
        current = torch.cuda.current_stream(side.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outs = eager(inputs)
        program = self._record(plan, inputs, side)
        current.wait_stream(side)
        for step in outs:               # made on the side stream, used here
            for v in step.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        if program is not None:
            self._cache_put(key, program)
        return outs

    # ---- program cache --------------------------------------------------
    def program_bytes_bound(self) -> Optional[int]:
        """The byte bound in force: ``max_program_bytes``, else
        :data:`PROGRAM_MEMORY_SHARE` of the device's memory on a card;
        ``None`` (no bound) on the CPU."""
        if self.max_program_bytes is not None:
            return self.max_program_bytes
        if self.device.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(self.device).total_memory
        return int(PROGRAM_MEMORY_SHARE * total)

    def program_cache_info(self) -> dict:
        """Live programs and their count bound, the device bytes they hold
        (``held_bytes``) and the byte bound, lifetime evictions."""
        bound = self.program_bytes_bound()
        held = self.held_bytes()
        with self._programs_lock:
            return {"programs": len(self._programs),
                    "max_programs": self.max_programs,
                    "held_bytes": held,
                    "max_program_bytes": bound,
                    "evictions": self.evictions}

    def graphs(self) -> int:
        """Captured CUDA graphs among the live programs."""
        with self._programs_lock:
            programs = list(self._programs.values())
        return sum(getattr(p, "graph", None) is not None for p in programs)

    def held_bytes(self) -> int:
        """Device bytes the live programs hold (static buffers and graph
        outputs; the graphs' pools may reserve more)."""
        with self._programs_lock:
            programs = list(self._programs.values())
        return sum(getattr(p, "nbytes", 0) for p in programs)

    def _cache_get(self, key):
        with self._programs_lock:
            program = self._programs.get(key)
            if program is not None:
                self._programs.move_to_end(key)
            return program

    def _cache_put(self, key, program) -> int:
        """Insert under the LRU bounds, releasing what falls out of them,
        oldest first: while more than ``max_programs`` programs are live,
        or while they hold more device bytes than the byte bound (the
        newest always stays; the bound is read only when programs hold
        bytes). Returns how many programs were dropped."""
        dropped = []
        with self._programs_lock:
            self._programs[key] = program
            self._programs.move_to_end(key)
            while len(self._programs) > self.max_programs:
                dropped.append(self._programs.popitem(last=False)[1])
            held = sum(getattr(p, "nbytes", 0)
                       for p in self._programs.values())
            bound = self.program_bytes_bound() if held else None
            if bound is not None:
                while held > bound and len(self._programs) > 1:
                    old = self._programs.popitem(last=False)[1]
                    held -= getattr(old, "nbytes", 0)
                    dropped.append(old)
            self.evictions += len(dropped)
        for p in dropped:
            p.release()
        return len(dropped)

    def release(self) -> None:
        """Release every program (engine shutdown)."""
        with self._programs_lock:
            dropped = list(self._programs.values())
            self._programs.clear()
        for p in dropped:
            p.release()


def _detached(outs_list: list[dict], inputs: dict) -> list[dict]:
    """Outputs that alias an input (a transpose of one) as copies, called
    inside the capture so that the copy is part of the graph: a program
    holds no view of its inputs, so a freed input's memory returns to the
    caller."""
    held = {t.untyped_storage().data_ptr() for t in inputs.values()}
    return [{k: v.clone(memory_format=torch.contiguous_format)
             if isinstance(v, torch.Tensor)
             and v.untyped_storage().data_ptr() in held else v
             for k, v in outs.items()} for outs in outs_list]


register = TorchBackend.register


def _from_host(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array on ``like``'s device, in ``like``'s dtype."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(
        device=like.device, dtype=like.dtype)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their common dtype (jnp promotes implicitly;
    torch.matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ---------------------------------------------------------------------------
# elemental
# ---------------------------------------------------------------------------
@register("elemental", "random_matrix", fusible=True, accepts=_DENSE)
def _random_matrix(rows: int, cols: int, seed: int = 0, scale: float = 1.0,
                   name: str = "random"):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((rows, cols))).astype(np.float32)
    return {"A": torch.from_numpy(a)}


@register("elemental", "replicate_cols", fusible=True, accepts=_DENSE)
def _replicate_cols(A, times: int):
    return {"A": A.repeat(1, times)}


@register("elemental", "multiply", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_multiply)
def _multiply(A, B):
    a, b = _promoted(A, B)
    return {"C": a @ b}


@register("elemental", "add", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_add)
def _add(A, B):
    if A.shape != B.shape:
        raise ValueError(f"add expects equal shapes, got {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    return {"C": A + B}


@register("elemental", "transpose", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_transpose)
def _transpose(A):
    return {"C": A.T}


@register("elemental", "gram", fusible=True, accepts=_DENSE,
          bucketable=True, out_shapes=base.shapes_gram)
def _gram(A, use_pallas: bool = False):
    return {"G": gram_ops.gram(A.contiguous())}


@register("elemental", "qr", fusible=True, accepts=_DENSE)
def _qr(A):
    q, r = torch.linalg.qr(A, mode="reduced")
    return {"Q": q, "R": r}


@register("elemental", "truncated_svd", accepts=_DENSE)
def _truncated_svd(A, k: int, oversample: int = 32, max_iters: int = 0,
                   seed: int = 0):
    """ARPACK-style driver: the shared host-side Lanczos loop
    (``reference._lanczos_gram``) around a device matvec X^T (X q), as
    the JAX backend drives its jitted ``_gram_matvec``."""
    x = A
    n, d = x.shape
    m = min(d, k + oversample) if max_iters == 0 else min(d, max_iters)
    q0 = np.random.default_rng(seed).standard_normal(d)

    def matvec(q):
        # each Lanczos iteration re-enters here: the natural QoS
        # preemption boundary for the reverse-communication driver
        base.yield_check()
        qd = _from_host(q, x)
        return (x.T @ (x @ qd)).double().cpu().numpy()

    sigma, V, iters, matvecs = _lanczos_gram(matvec, d, k, m, q0)
    v_dev = _from_host(V, x)
    U = (x @ v_dev) / torch.clamp(_from_host(sigma, x), min=1e-30)
    return {"U": U, "S": torch.from_numpy(sigma.astype(np.float32)),
            "V": v_dev, "lanczos_iters": iters, "matvecs": matvecs}


@register("elemental", "gram_svd", fusible=True, accepts=_DENSE)
def _gram_svd(A, k: int, use_pallas: bool = False):
    x = A
    g = gram_ops.gram(x.contiguous())
    evals, evecs = torch.linalg.eigh(g)
    order = torch.flip(torch.argsort(evals), dims=(0,))[:k]
    lam = torch.clamp(evals[order], min=0.0)
    sigma = torch.sqrt(lam)
    v = evecs[:, order]
    u = (x @ v.to(x.dtype)) / torch.clamp(sigma.to(x.dtype), min=1e-30)
    return {"U": u, "S": sigma.float(), "V": v.float()}


@register("elemental", "randomized_svd", accepts=_DENSE)
def _randomized_svd(A, k: int, oversample: int = 8, power_iters: int = 2,
                    seed: int = 0):
    x = A
    n, d = x.shape
    ell = min(d, k + oversample)
    rng = np.random.default_rng(seed)
    omega = _from_host(rng.standard_normal((d, ell)), x)
    y = x @ omega
    for _ in range(power_iters):
        y = x @ (x.T @ y)
    q, _ = torch.linalg.qr(y, mode="reduced")
    b = q.T @ x                                                # (ell, d)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    return {"U": q @ ub[:, :k], "S": s[:k], "V": vt[:k].T}


# ---------------------------------------------------------------------------
# skylark
# ---------------------------------------------------------------------------
@register("skylark", "random_features", accepts=_DENSE)
def _random_features(X, rf_dim: int, bandwidth: float = 1.0, seed: int = 0):
    return {"Z": rf_ops.rf_map(X.contiguous(), rf_dim, bandwidth=bandwidth,
                               seed=seed)}


def _cg_step(x, lam_n, state):
    """One CG iteration on the normal equations; X^T (X p) is one
    normal_matvec launch (mirrors the JAX backend's ``_cg_step``). A
    column whose residual reached exactly zero has converged and stays
    as it is: its step sizes would be 0/0, and one NaN column ends the
    solve (the loop's max residual is NaN) with NaN in W."""
    w, r, p, rs = state
    ap = nm_ops.normal_matvec(x, p.float()).to(x.dtype) + lam_n * p
    pap = torch.sum(p * ap, dim=0)
    alpha = torch.where(pap != 0, rs / pap, torch.zeros_like(rs))
    w = w + alpha * p
    r = r - alpha * ap
    rs_new = torch.sum(r * r, dim=0)
    beta = torch.where(rs != 0, rs_new / rs, torch.zeros_like(rs))
    p = r + beta * p
    return w, r, p, rs_new


@register("skylark", "cg_solve", accepts=_DENSE)
def _cg_solve(X, Y, lam: float = 1e-5, rf_dim: int = 0,
              bandwidth: float = 1.0, max_iters: int = 200,
              tol: float = 1e-8, seed: int = 0, use_pallas: bool = False):
    x = X.contiguous()
    if rf_dim:
        x = rf_ops.rf_map(x, rf_dim, bandwidth=bandwidth, seed=seed)
    x, y = _promoted(x, Y)
    n, d = x.shape
    lam_n = torch.tensor(n * lam, dtype=x.dtype, device=x.device)

    b = x.T @ y                                  # (d, c) rhs
    b_norm = torch.linalg.norm(b, dim=0)
    w = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=0)

    iters = 0
    floor = torch.clamp(b_norm, min=1e-30)
    rel = float(torch.max(torch.sqrt(rs) / floor))
    history = [rel]
    state = (w, r, p, rs)
    while iters < max_iters and rel > tol:
        base.yield_check()          # QoS iteration boundary
        state = _cg_step(x, lam_n, state)
        iters += 1
        rel = float(torch.max(torch.sqrt(state[3]) / floor))
        history.append(rel)

    return {
        "W": state[0],
        "iterations": iters,
        "relative_residual": rel,
        "residual_history": [float(h) for h in history],
        "expanded_dim": int(d),
    }


@register("skylark", "nmf", accepts=_DENSE)
def _nmf(A, k: int, max_iters: int = 100, seed: int = 0, eps: float = 1e-9):
    x = torch.clamp(A, min=0.0)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    scale = float(np.sqrt(float(torch.mean(x)) / k))
    w = _from_host(scale * rng.uniform(0.1, 1.0, (n, k)), x)
    h = _from_host(scale * rng.uniform(0.1, 1.0, (k, d)), x)
    for _ in range(max_iters):
        base.yield_check()          # QoS iteration boundary
        h = h * (w.T @ x) / (w.T @ (w @ h) + eps)
        w = w * (x @ h.T) / (w @ (h @ h.T) + eps)
    resid = float(torch.linalg.norm(x - w @ h) / torch.linalg.norm(x))
    return {"W": w, "H": h, "relative_residual": resid,
            "iterations": max_iters}


# ---------------------------------------------------------------------------
# mllib — shared with the reference backend: the pure-Spark baseline is
# client-side row-partitioned math by construction; accelerating it would
# unmake the comparison
# ---------------------------------------------------------------------------
register("mllib", "cg_solve", accepts=_DENSE)(mllib_cg_solve)
register("mllib", "truncated_svd", accepts=_DENSE)(mllib_truncated_svd)
