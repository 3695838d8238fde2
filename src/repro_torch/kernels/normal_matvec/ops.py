"""Public wrapper of the normal-equations matvec. The device decides: the
plain version for a CPU tensor, the CUDA kernel for a CUDA tensor — at any
d (the TPU wrapper's d <= 8192 cap has no counterpart here)."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.normal_matvec.normal_matvec import \
    normal_matvec_cuda
from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref

LAUNCHES = device.LaunchCounter()


def normal_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w -> X^T (X w) with fp32 accumulation; x (n, d) fp32/bf16, w (d, c)
    fp32, both contiguous. Returns (d, c) fp32."""
    device.require_matrix("normal_matvec", "x", x)
    device.require_matrix("normal_matvec", "w", w, (torch.float32,))
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"normal_matvec: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    with device.kernel_span("normal_matvec", x, w):
        if device.on_cpu("normal_matvec", x, w):
            return normal_matvec_ref(x, w)
        device.require_nonempty("normal_matvec", n=x.shape[0],
                                d=x.shape[1], c=w.shape[1])
        out = normal_matvec_cuda(x, w)
        LAUNCHES.add()
        return out
