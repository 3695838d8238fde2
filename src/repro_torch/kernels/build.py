"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles on first use, with ``nvcc``, into its own shared
library with a plain C interface, loaded through ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries land in ``_build/`` beside
this package (listed in ``.gitignore``), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads
as is. Nothing builds at import time: the CPU tests import every module
on a machine without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``load(name)`` returns the loaded library, building it first if
needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.analysis import locktrace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("gram", "normal_matvec", "rf_map", "swa", "swa_bwd",
           "lru_scan")

# No --use_fast_math: it turns cosf into __cosf, which is wrong at the
# |XW + b| of tens that random features reach.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_C = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
SIGNATURES = {
    # entry: argtypes (dtype, pointers..., sizes..., [nt,] [slabs | scale],
    # stream); gram's last size is a slab's rows
    "gram": ("gram_launch", [_INT, _C, _C, _C, _I64, _I64, _I64, _C]),
    "normal_matvec": ("normal_matvec_launch",
                      [_INT, _C, _C, _C, _C, _C, _C, _I64, _I64, _I64, _INT,
                       _INT, _C]),
    # (dtype, x, w, b, wt, z, n, d, D, scale, blocks, stream)
    "rf_map": ("rf_map_launch",
               [_INT, _C, _C, _C, _C, _C, _I64, _I64, _I64, ctypes.c_float,
                _INT, _C]),
    # (dtype, head_dim, q, k, v, o, B, H, K, S, 12 strides, window,
    # prefix, scale, fp16 v scratch or null, max |v| scratch or null, lse
    # or null, fp32 out or null, stream)
    "swa": ("swa_launch",
            [_INT, _INT, _C, _C, _C, _C, _I64, _I64, _I64, _I64,
             ctypes.POINTER(_I64), _I64, _I64, ctypes.c_float, _C, _C, _C,
             _C, _C]),
    # (dtype, head_dim, q, k, v, fp32 o, dout, lse, dvec, dq, dk, dv, dK/dV
    # partials or null, B, H, K, S, splits, 24 strides, window, prefix,
    # scale, stream)
    "swa_bwd": ("swa_bwd_launch",
                [_INT, _INT, _C, _C, _C, _C, _C, _C, _C, _C, _C, _C, _C,
                 _I64, _I64, _I64, _I64, _I64, ctypes.POINTER(_I64), _I64,
                 _I64, ctypes.c_float, _C]),
    # (dtype, reverse, a, b, h0, out, h or null, h_init or null, da or
    # null, workspace, B, S, W, stream)
    "lru_scan": ("lru_scan_launch",
                 [_INT, _INT, _C, _C, _C, _C, _C, _C, _C, _C, _I64, _I64,
                  _I64, _C]),
}

# one build at a time; taken under the backend's capture lock when warmup
# builds a kernel (a leaf: nothing is acquired under it)
_lock = locktrace.make_lock("kernels.build")
_loaded: dict[str, ctypes.CDLL] = {}
#: ptxas report and wall seconds of each build this process ran
build_log: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels build only on a machine with the CUDA toolkit")


def _sources(name: str) -> list[Path]:
    """``name``.cu and every header of ``csrc/``: an edited header rebuilds
    every kernel, whichever of them include it."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the nvcc of one kernel unless its library exists; returns
    (process, temporary output, final path, start time) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)         # atomic: a concurrent loader sees all or none
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build_all(names=KERNELS) -> None:
    """Compile every named kernel that is not built yet, one nvcc per
    source, all running at once."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish(n, s)       # reap every nvcc even after a failure
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed, with its
    entry's argument types declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            entry, argtypes = SIGNATURES[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib


#: launch statuses above this are tensor maps the driver could not make
#: (``csrc/hopper_bf16.cuh`` ENCODE_MISSING: no encoder; above it, 1 + the
#: CUresult of a refused map)
ENCODE_MISSING = 10000


def check(name: str, err: int) -> None:
    """Raise on a non-zero status returned by a launch entry: a
    cudaError_t, or a tensor map the driver could not make."""
    if err >= ENCODE_MISSING:
        raise RuntimeError(
            f"{name} kernel launch failed: no tensor map (the driver has no "
            "cuTensorMapEncodeTiled)" if err == ENCODE_MISSING else
            f"{name} kernel launch failed: the driver refused a tensor map "
            f"(CUresult {err - ENCODE_MISSING - 1})")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
