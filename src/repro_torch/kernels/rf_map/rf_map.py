"""Launcher of the CUDA random-feature map (``repro_torch/csrc/rf_map.cu``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, device

#: output columns of one tile of the kernel (csrc/rf_map.cu BN)
COLUMN_TILE = 160


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def rf_map_cuda(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """sqrt(2/D) cos(X W + b) on the card, scaled by the true D: x
    contiguous (n, d) fp32/bf16, w contiguous (d, D) fp32, b contiguous
    (D,) fp32, all CUDA. Scratch: W^T in 32-deep tiles, round32(d) x
    (D rounded up to a column tile) floats."""
    n, d = x.shape
    dd = w.shape[1]
    z = torch.empty((n, dd), dtype=torch.float32, device=x.device)
    wt = torch.empty((_round_up(d, 32), _round_up(dd, COLUMN_TILE)),
                     dtype=torch.float32, device=x.device)
    lib = build.load("rf_map")
    with torch.cuda.device(x.device):
        err = lib.rf_map_launch(device.dtype_code(x), x.data_ptr(),
                                w.data_ptr(), b.data_ptr(), wt.data_ptr(),
                                z.data_ptr(), n, d, dd, math.sqrt(2.0 / dd),
                                device.sm_count(x), device.stream_ptr(x))
    build.check("rf_map", err)
    return z
