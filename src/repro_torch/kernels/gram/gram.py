"""Launcher of the CUDA Gram kernel (``repro_torch/csrc/gram.cu``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, device

#: rows of A one stage of the kernel takes (csrc/tf32_mainloop.cuh BK): a
#: slab's rows are a multiple of it
STAGE_ROWS = 32


def slab_rows(n: int, slabs: int) -> int:
    """Rows of each of ``slabs`` slabs over ``n`` rows (the last may hold
    fewer), a multiple of ``STAGE_ROWS``."""
    return math.ceil(math.ceil(n / slabs) / STAGE_ROWS) * STAGE_ROWS


def gram_slabs(n: int, d: int, sms: int) -> int:
    """Row slabs of one launch. Only tiles on or above the diagonal run,
    one block to an SM at a time: the fewest whole waves of blocks in which
    no slab is longer than ``device.MAX_SLAB_ROWS``, with as many slabs as
    those waves hold, each keeping at least ``device.MIN_SLAB_ROWS`` rows.
    Depends on shapes and the card only, so a result repeats from run to
    run."""
    t = device.tiles(d)
    upper = t * (t + 1) // 2
    accuracy = max(1, math.ceil(n / device.MAX_SLAB_ROWS))
    waves = math.ceil(accuracy * upper / sms)
    want = max(accuracy, min(waves * sms // upper,
                             n // device.MIN_SLAB_ROWS))
    return math.ceil(n / slab_rows(n, want))


def gram_cuda(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A on the card. ``a``: contiguous (n, d) fp32/bf16 CUDA."""
    n, d = a.shape
    slabs = gram_slabs(n, d, device.sm_count(a))
    out = torch.empty((d, d), dtype=torch.float32, device=a.device)
    part = torch.empty((slabs, d, d), dtype=torch.float32, device=a.device) \
        if slabs > 1 else out
    lib = build.load("gram")
    with torch.cuda.device(a.device):
        err = lib.gram_launch(device.dtype_code(a), a.data_ptr(),
                              part.data_ptr(), out.data_ptr(), n, d,
                              slab_rows(n, slabs), device.stream_ptr(a))
    build.check("gram", err)
    return out
