"""Launcher of the CUDA sliding-window attention
(``repro_torch/csrc/swa.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int) -> torch.Tensor:
    """Sliding-window causal attention on the card. q (B, H, S, D), k and v
    (B, K, S, D), one type (fp32/bf16), any strides with D contiguous.
    Returns q's type, laid out like q (``empty_like``), so a (B, S, H, D)
    buffer viewed as (B, H, S, D) comes back as such a view."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = build.load("swa")
    with torch.cuda.device(q.device):
        err = lib.swa_launch(device.dtype_code(q), d, q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                             h, k.shape[1], s, strides, window, d ** -0.5,
                             device.stream_ptr(q))
    build.check("swa", err)
    return out
