"""Launcher of the CUDA normal-equations matvec
(``repro_torch/csrc/normal_matvec.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, device


def normal_matvec_slabs(n: int, d: int, c: int, sms: int) -> int:
    """Row slabs of the X^T t launch."""
    return device.split_slabs(device.tiles(d, c), n, sms)


def normal_matvec_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^T (X w) on the card: x contiguous (n, d) fp32/bf16, w contiguous
    (d, c) fp32, both CUDA. Scratch: t = X w (n, c) and, for a split
    reduction, the per-slab partials."""
    n, d = x.shape
    c = w.shape[1]
    slabs = normal_matvec_slabs(n, d, c, device.sm_count(x))
    t = torch.empty((n, c), dtype=torch.float32, device=x.device)
    out = torch.empty((d, c), dtype=torch.float32, device=x.device)
    part = torch.empty((slabs, d, c), dtype=torch.float32, device=x.device) \
        if slabs > 1 else out
    lib = build.load("normal_matvec")
    with torch.cuda.device(x.device):
        err = lib.normal_matvec_launch(
            device.dtype_code(x), x.data_ptr(), w.data_ptr(), t.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, d, c, slabs,
            device.stream_ptr(x))
    build.check("normal_matvec", err)
    return out
