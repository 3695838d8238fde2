"""Launchers of the CUDA sliding-window attention and its backward
(``repro_torch/csrc/swa.cu``, ``repro_torch/csrc/swa_bwd.cu``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, device


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int, with_lse: bool = False
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sliding-window causal attention on the card. q (B, H, S, D), k and v
    (B, K, S, D), one type (fp32/bf16), any strides with D contiguous.
    Returns (out, lse): out in q's type, laid out like q (``empty_like``),
    so a (B, S, H, D) buffer viewed as (B, H, S, D) comes back as such a
    view; with ``with_lse`` each row's log-sum-exp, fp32 contiguous
    (B, H, S), else None (nothing more is written)."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = build.load("swa")
    with torch.cuda.device(q.device):
        err = lib.swa_launch(device.dtype_code(q), d, q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                             h, k.shape[1], s, strides, window, d ** -0.5,
                             lse.data_ptr() if lse is not None else None,
                             device.stream_ptr(q))
    build.check("swa", err)
    return out, lse


def swa_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                 window: int) -> tuple:
    """dQ, dK, dV of :func:`swa_cuda` on the card, from its inputs, its
    output ``o``, its ``lse`` (fp32 contiguous (B, H, S)) and the output's
    gradient ``dout`` (o's shape and type). Every tensor D-contiguous,
    other strides free. Returns the three gradients in the input type,
    each laid out like its input."""
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(
        st for t in (q, k, v, o, dout, dq, dk, dv) for st in t.stride()[:3]))
    lib = build.load("swa_bwd")
    with torch.cuda.device(q.device):
        err = lib.swa_bwd_launch(
            device.dtype_code(q), d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            h, k.shape[1], s, strides, window, d ** -0.5,
            device.stream_ptr(q))
    build.check("swa_bwd", err)
    return dq, dk, dv
