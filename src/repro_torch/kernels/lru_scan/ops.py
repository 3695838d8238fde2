"""Public wrapper of the gated linear recurrence. The device decides: the
plain version for a CPU tensor, the CUDA kernel for a CUDA tensor. Forward
only, as the TPU kernel: it serves prefill."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.lru_scan.lru_scan import lru_scan_cuda
from repro_torch.kernels.lru_scan.ref import lru_scan_ref

#: kernel launches (CUDA tensors only)
LAUNCHES = device.LaunchCounter()


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over (B, S, W) from h0 (B, W); returns
    every state, (B, S, W) fp32. ``a`` and ``b`` are contiguous fp32 or
    bf16 of one type; ``h0`` is contiguous fp32. Any S and W."""
    for name, t in (("a", a), ("b", b)):
        device.require_tensor("lru_scan", name, t, 3)
    device.require_tensor("lru_scan", "h0", h0, 2, (torch.float32,))
    if b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype} differ")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"lru_scan: h0 {tuple(h0.shape)} is not (B, W) = "
                         f"{(a.shape[0], a.shape[2])}")
    if device.on_cpu("lru_scan", a, b, h0):
        return lru_scan_ref(a, b, h0)
    device.require_nonempty("lru_scan", B=a.shape[0], S=a.shape[1],
                            W=a.shape[2])
    device.require_grid("lru_scan", batch=a.shape[0])
    out = lru_scan_cuda(a, b, h0)
    LAUNCHES.add()
    return out
