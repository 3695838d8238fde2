"""Launcher of the CUDA linear recurrence
(``repro_torch/csrc/lru_scan.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, device

#: time steps of a chunk and warps of a block, the kernel's compile-time
#: constants (``csrc/lru_scan.cu``); ``lru_scan_chunked_ref`` emulates the
#: association they give
CHUNK, WARPS = 256, 8


def workspace_words(batch: int, s: int, w: int, chunk: int = CHUNK) -> int:
    """64-bit words of the kernel's workspace: the ticket, then a carry
    slot per (chunk, batch row, channel) with channels padded to 32."""
    return 1 + batch * -(-w // 32) * 32 * -(-s // chunk)


def lru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  reverse: bool = False, h: torch.Tensor | None = None,
                  h_init: torch.Tensor | None = None):
    """All states of h_t = a_t h_{t-1} + b_t on the card, or with
    ``reverse`` of y_t = a_{t+1} y_{t+1} + b_t from the last step down: a,
    b contiguous (B, S, W) of one type (fp32/bf16), h0 contiguous (B, W)
    fp32, all CUDA. Returns (B, S, W) fp32; with ``reverse`` and ``h``
    (the forward's states, (B, S, W) fp32) and ``h_init`` (its h0) also
    da_t = y_t h_{t-1}, as a pair. The carry workspace is zeroed on the
    tensors' stream, so nothing waits on the host."""
    batch, s, w = a.shape
    out = torch.empty((batch, s, w), dtype=torch.float32, device=a.device)
    da = torch.empty_like(out) if h is not None else None
    work = torch.zeros(workspace_words(batch, s, w),
                       dtype=torch.int64, device=a.device)
    lib = build.load("lru_scan")
    with torch.cuda.device(a.device):
        err = lib.lru_scan_launch(
            device.dtype_code(a), int(reverse), a.data_ptr(), b.data_ptr(),
            h0.data_ptr(), out.data_ptr(),
            None if h is None else h.data_ptr(),
            None if h_init is None else h_init.data_ptr(),
            None if da is None else da.data_ptr(), work.data_ptr(), batch,
            s, w, device.stream_ptr(a))
    build.check("lru_scan", err)
    return out if da is None else (out, da)
