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
engine. :meth:`TorchBackend.compile` decides from the plan alone, before
any launch, how it runs:

* on a CUDA device, a plan whose every step is capture-safe
  (:data:`CAPTURE_SAFE`: ``multiply``, ``add``, ``transpose``, ``gram``,
  ``replicate_cols``) becomes one **CUDA graph**, captured on first use
  and replayed afterwards: the port's counterpart of the JAX backend's
  single ``jax.jit`` program. Captured programs are held in a bounded
  LRU keyed by the plan's signature and each input's shape, stride,
  dtype, device and address (:func:`program_key`);
* capture is refused for a plan holding any other step, which then runs
  eagerly, still as one task: ``random_matrix`` draws on the host and
  hands back a CPU tensor (a copy from pageable memory cannot be
  captured), and ``qr`` and ``gram_svd`` (``torch.linalg.qr``,
  ``torch.linalg.eigh``) check LAPACK's info on the host, which
  synchronises. All three stay ``fusible``, so the catalogs do not
  change;
* on the CPU every plan runs eagerly, step by step, in one task.

A capture runs on a side stream in ``thread_local`` mode, so other
workers go on launching, copying, allocating and synchronising their
own streams meanwhile. Two things of theirs still collide with it: a
device-wide ``torch.cuda.synchronize`` (it fails, and invalidates the
capture; the engine waits on its worker's stream instead), and a draw
from the default CUDA generator (PyTorch registers that generator with
every capture); the engine's routines draw on the host.

There is no ``get_or_compile``, ``pad_to`` or AOT warmup: single ops run
eagerly, unbucketed. Host-loop drivers (Lanczos SVD, CG, NMF) are
reverse-communication loops around device products, as in the JAX
backend, and are never fused.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import locktrace
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

#: default bound on captured programs held live (LRU), as the JAX backend
#: bounds its compiled programs
DEFAULT_MAX_PROGRAMS = 128

#: the routines whose implementation here may be captured into a CUDA
#: graph: device work only, on the current stream, with no host
#: synchronisation and no copy from pageable memory
CAPTURE_SAFE = frozenset(("elemental", r) for r in (
    "multiply", "add", "transpose", "gram", "replicate_cols"))


def program_key(plan: base.ExecutionPlan,
                inputs: dict) -> Optional[tuple]:
    """The key of a plan's captured program: its signature plus, for each
    input, its shape, stride, dtype, device and address. A CUDA graph
    reads its inputs where they lay at capture, without copying them into
    buffers of its own (a resident matrix may be half the card), so a
    replay is right for any tensor at that address with that shape,
    stride and dtype, and a new address is a new capture. ``None`` when
    an argument is unhashable."""
    sig = plan.signature()
    if sig is None:
        return None
    return sig, tuple(sorted(
        (slot, tuple(t.shape), tuple(t.stride()), str(t.dtype),
         str(t.device), t.data_ptr()) for slot, t in inputs.items()))


def _interpret(plan: base.ExecutionPlan, inputs: dict) -> list[dict]:
    """Every step of the plan in order, nothing between them: the body a
    capture records."""
    outs: list[dict] = []
    for step in plan.steps:
        outs.append(step.impl.fn(**base.resolve_step_args(step, outs,
                                                          inputs)))
    return outs


class _Program:
    """One captured plan: its CUDA graph, the outputs the graph writes at
    every replay (in the graph's private memory pool), and the kernel
    launches its capture recorded."""

    def __init__(self, graph, outs: list[dict], launches: dict):
        self.graph = graph
        self.outs = outs
        self.launches = launches
        self.lock = threading.Lock()
        self.done = None        # event after the last replay's copies

    def replay(self) -> Optional[list[dict]]:
        """Replay on the current stream and hand out copies of the
        outputs: the next replay overwrites the graph's own. The lock keeps
        a second worker's replay from overwriting them before they are
        copied; ``done`` orders a replay on another stream after the last
        copies. ``None`` once the program was released."""
        with self.lock:
            if self.graph is None:
                return None
            stream = torch.cuda.current_stream()
            if self.done is not None:
                stream.wait_event(self.done)
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
        """Drop the graph and its outputs, returning its pool."""
        with self.lock:
            if self.graph is None:
                return
            if self.done is not None:
                self.done.synchronize()
            self.graph.reset()
            self.graph = self.outs = None


class TorchBackend(base.ExecutionBackend):
    """PyTorch execution on the engine's device; a burst chain runs as one
    task, replayed from a CUDA graph on a card where every step allows
    capture.

    Captured programs are held in a bounded LRU (``max_programs``);
    ``capture_failures`` counts captures that failed on the card (the
    call is then answered by the eager run before it, and nothing is
    kept), which no run should see."""

    name = "torch"
    supports_fusion = True

    def __init__(self):
        super().__init__()
        self._programs: "collections.OrderedDict[tuple, _Program]" = \
            collections.OrderedDict()
        self._programs_lock = locktrace.make_lock("backend.programs")
        # one capture at a time, on this backend's side stream
        self._capture_lock = threading.Lock()
        self._side_stream = None
        #: bound on live programs (the engine's ``program_cache_size``)
        self.max_programs = DEFAULT_MAX_PROGRAMS
        #: programs dropped by the LRU bound since construction
        self.evictions = 0
        #: captures that raised on the card (each answered eagerly)
        self.capture_failures = 0
        #: seconds spent capturing programs that were kept
        self.capture_seconds = 0.0

    def to_native(self, array) -> torch.Tensor:
        return array if isinstance(array, torch.Tensor) \
            else torch.as_tensor(array)

    def is_array(self, value) -> bool:
        return isinstance(value, (torch.Tensor, np.ndarray)) and \
            value.ndim >= 1

    # ---- chain fusion ---------------------------------------------------
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
        plan runs eagerly in one task, unless it is :meth:`capturable` and
        its inputs lie on a card: then it replays its captured CUDA graph,
        captured on first use."""
        eager = super().compile(plan)
        if not self.capturable(plan):
            return eager

        def run(inputs: dict) -> list[dict]:
            if not inputs or not all(isinstance(t, torch.Tensor)
                                     and t.is_cuda
                                     for t in inputs.values()):
                return eager(inputs)
            return self._run_graph(plan, eager, inputs)
        return run

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
        outside the capture and answers this call, then capture it there.
        ``thread_local`` capture lets other workers launch and synchronise
        their own streams meanwhile without breaking it or being broken by
        it (see the module's docstring for what still collides)."""
        with self._capture_lock:
            if self._cache_get(key) is None:
                return self._capture_locked(key, plan, eager, inputs)
        # another worker captured it meanwhile
        return self._run_graph(plan, eager, inputs)

    def _capture_locked(self, key, plan, eager, inputs: dict) -> list[dict]:
        dev = next(iter(inputs.values())).device
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        side = self._side_stream
        current = torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outs = eager(inputs)
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
            static = None
        current.wait_stream(side)
        for step in outs:               # made on the side stream, used here
            for v in step.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        if static is not None:
            self.capture_seconds += time.perf_counter() - t0
            self._cache_put(key, _Program(graph, static, launches))
        return outs

    # ---- program cache --------------------------------------------------
    def program_cache_info(self) -> dict:
        """Live captured programs, their bound, lifetime evictions."""
        with self._programs_lock:
            return {"programs": len(self._programs),
                    "max_programs": self.max_programs,
                    "evictions": self.evictions}

    def _cache_get(self, key) -> Optional[_Program]:
        with self._programs_lock:
            program = self._programs.get(key)
            if program is not None:
                self._programs.move_to_end(key)
            return program

    def _cache_put(self, key, program: _Program) -> None:
        """Insert under the LRU bound, releasing what falls out of it."""
        dropped = []
        with self._programs_lock:
            self._programs[key] = program
            self._programs.move_to_end(key)
            while len(self._programs) > self.max_programs:
                dropped.append(self._programs.popitem(last=False)[1])
            self.evictions += len(dropped)
        for p in dropped:
            p.release()

    def release(self) -> None:
        """Release every captured program (engine shutdown)."""
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
