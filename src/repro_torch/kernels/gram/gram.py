"""Launcher of the CUDA Gram kernel (``repro_torch/csrc/gram.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, device


def gram_slabs(n: int, d: int, sms: int) -> int:
    """Row slabs of one launch: only tiles on or above the diagonal run."""
    t = device.tiles(d)
    return device.split_slabs(t * (t + 1) // 2, n, sms)


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
                              part.data_ptr(), out.data_ptr(), n, d, slabs,
                              device.stream_ptr(a))
    build.check("gram", err)
    return out
