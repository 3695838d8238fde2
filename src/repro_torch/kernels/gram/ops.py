"""Public wrapper of the Gram kernel. The device decides: the plain
version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.gram.gram import gram_cuda
from repro_torch.kernels.gram.ref import gram_ref

LAUNCHES = device.LaunchCounter()


def gram(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A (fp32 accumulation) of a contiguous (n, d) fp32/bf16
    matrix."""
    device.require_matrix("gram", "a", a)
    if device.on_cpu("gram", a):
        return gram_ref(a)
    device.require_nonempty("gram", n=a.shape[0], d=a.shape[1])
    g = gram_cuda(a)
    LAUNCHES.add()
    return g
