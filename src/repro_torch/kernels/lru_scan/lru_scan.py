"""Launcher of the CUDA linear recurrence
(``repro_torch/csrc/lru_scan.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, device


def lru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """All states of h_t = a_t h_{t-1} + b_t on the card, or with
    ``reverse`` of y_t = a_{t+1} y_{t+1} + b_t from the last step down: a,
    b contiguous (B, S, W) of one type (fp32/bf16), h0 contiguous (B, W)
    fp32, all CUDA. Returns (B, S, W) fp32."""
    batch, s, w = a.shape
    out = torch.empty((batch, s, w), dtype=torch.float32, device=a.device)
    lib = build.load("lru_scan")
    with torch.cuda.device(a.device):
        err = lib.lru_scan_launch(device.dtype_code(a), int(reverse),
                                  a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                  out.data_ptr(), batch, s, w,
                                  device.stream_ptr(a))
    build.check("lru_scan", err)
    return out
