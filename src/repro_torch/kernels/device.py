"""What every kernel wrapper checks before it dispatches, and the small
facts its launcher passes to a CUDA entry.

The rule the wrappers share: a tensor on the CPU takes the kernel's plain
PyTorch version; a tensor on a CUDA device launches the hand-written
kernel or raises. There is no fallback from one to the other, and no
other device.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch

from repro_torch.analysis import locktrace

FLOAT_INPUTS = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# output tiles of the fp32 kernels (csrc/fp32_tiles.cuh)
TILE = 128
# a split reduction aims at this many blocks per SM (two resident at a
# time, two waves), so the last wave's tail is a small share of the run
BLOCKS_PER_SM = 4
MIN_SLAB_ROWS = 256
# no slab runs longer than this: one fp32 accumulator over n rows of a sum
# that grows with n (a Gram diagonal, X^T X w) rounds with an error that
# grows like n^1.5; at 1,048,576 rows that is ~15 on a diagonal of ~1e6,
# past the 2e-5 tolerance. 65,536-row slabs cut it 64-fold.
MAX_SLAB_ROWS = 65_536


def require_matrix(kernel: str, name: str, t, dtypes=FLOAT_INPUTS) -> None:
    """Raise unless ``t`` is a contiguous 2-D tensor of one of ``dtypes``."""
    require_tensor(kernel, name, t, 2, dtypes)


def require_tensor(kernel: str, name: str, t, ndim: int,
                   dtypes=FLOAT_INPUTS, contiguous: bool = True) -> None:
    """Raise unless ``t`` is an ``ndim``-D tensor of one of ``dtypes``,
    contiguous (row-major) when ``contiguous``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} dtype {t.dtype} not in "
                        f"{[str(d) for d in dtypes]}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous (row-major)")


_settle_lock = locktrace.make_lock("kernels.settle")
_settled = False


def settle_cpu_vector_math() -> None:
    """Run each elementwise function the plain versions use once, on one
    element, before any of them runs in several threads.

    ATen computes float cos, exp and the like on the CPU through MKL's
    vector math, which sets itself up on its first call. When that first
    call is split across OpenMP threads at once, one thread's chunk can
    come from a less accurate path: the first ``cos_`` of a 256 x 256
    random-feature map came out up to 1.5e-4 off on 8,192 elements (one
    thread's share) in about 3 % of fresh processes on a loaded CPU, and
    never after a one-element call, which runs on the calling thread
    alone (below ATen's 2,048-element grain)."""
    global _settled
    if _settled:
        return
    with _settle_lock:
        if not _settled:
            one = torch.ones(1)
            for fn in (torch.cos, torch.sin, torch.exp, torch.log,
                       torch.log1p, torch.tanh, torch.sqrt, torch.rsqrt,
                       torch.sigmoid, torch.nn.functional.softplus,
                       functools.partial(torch.nn.functional.gelu,
                                         approximate="tanh")):
                fn(one)
            _settled = True


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises
    for mixed devices and for any other device type. Before the first
    plain version runs on the CPU, settles MKL's vector math
    (:func:`settle_cpu_vector_math`)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type == "cpu":
        settle_cpu_vector_math()
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"{kernel}: device {dev} is not supported (cpu or "
                     "cuda)")


def require_nonempty(kernel: str, **dims: int) -> None:
    """The CUDA launchers take no empty dimension (an empty grid is not a
    valid launch)."""
    empty = [k for k, v in dims.items() if v < 1]
    if empty:
        raise ValueError(f"{kernel}: empty dimension(s) {empty} "
                         f"({dims}) on CUDA")


def require_grid(kernel: str, axis: str = "y", **dims: int) -> None:
    """A launch puts these dimensions on a grid's ``axis``: y and z hold
    at most 65,535 blocks, x 2**31 - 1."""
    most = 2 ** 31 - 1 if axis == "x" else 65_535
    big = {k: v for k, v in dims.items() if v > most}
    if big:
        raise ValueError(f"{kernel}: {big} exceed the {most:,} blocks of a "
                         f"grid's {axis} axis on CUDA")


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODE[t.dtype]


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def split_slabs(tiles: int, rows: int, sms: int) -> int:
    """How many row slabs a tiled reduction over ``rows`` is split into:
    enough that no slab is longer than ``MAX_SLAB_ROWS``; and, when the
    ``tiles`` output tiles cannot give every SM two blocks, enough for
    ``BLOCKS_PER_SM`` blocks per SM, each slab keeping at least
    ``MIN_SLAB_ROWS`` rows. Depends on shapes and the card only, so a
    result repeats from run to run."""
    accuracy = math.ceil(rows / MAX_SLAB_ROWS)
    if tiles >= 2 * sms:
        return max(1, accuracy)
    want = math.ceil(BLOCKS_PER_SM * sms / max(1, tiles))
    return max(1, accuracy, min(want, rows // MIN_SLAB_ROWS, 65535))


def tiles(*dims: int) -> int:
    """Number of TILE x TILE output tiles covering ``dims``."""
    out = 1
    for d in dims:
        out *= math.ceil(d / TILE)
    return out


# per thread: the launches a CUDA graph capture on that thread recorded
# instead of counting (see :func:`capturing_launches`)
_captured = threading.local()


class LaunchCounter:
    """A count of kernel launches, safe to bump from engine worker
    threads. ``chip_smoke.py`` zeroes every counter before it drives the
    main path and reads them after, to show the path went through the
    kernels.

    A wrapper called while its thread captures a CUDA graph launches
    nothing: the kernel goes into the graph. Its ``add`` is then recorded
    for the capture, which adds it again at every replay of the graph
    (:func:`capturing_launches`, :meth:`add` with ``n``)."""

    def __init__(self) -> None:
        self._lock = locktrace.make_lock("kernels.launches")
        self.value = 0

    def add(self, n: int = 1) -> None:
        recorded = getattr(_captured, "counts", None)
        if recorded is not None:
            recorded[self] = recorded.get(self, 0) + n
            return
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


@contextlib.contextmanager
def capturing_launches():
    """Around a CUDA graph capture on this thread: the launch counters
    bumped inside record into the dict it yields (counter -> launches
    captured) instead of counting, since a captured kernel is not
    launched. Other threads count as usual."""
    if getattr(_captured, "counts", None) is not None:
        raise RuntimeError("a capture is already recording launches on "
                           "this thread")
    _captured.counts = {}
    try:
        yield _captured.counts
    finally:
        _captured.counts = None
