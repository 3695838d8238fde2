"""Public wrapper of the random-feature map. The device decides: the plain
version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
from repro_torch.kernels.rf_map.rf_map import rf_map_cuda

LAUNCHES = device.LaunchCounter()


def rf_map(x: torch.Tensor, rf_dim: int, *, bandwidth: float = 1.0,
           seed: int = 0) -> torch.Tensor:
    """Z = sqrt(2/D) cos(X W + b) with (W, b) drawn by
    :func:`~repro_torch.kernels.rf_map.ref.rf_weights`."""
    w, b = rf_weights(x.shape[1], rf_dim, bandwidth, seed)
    return rf_map_apply(x, torch.from_numpy(w).to(x.device),
                        torch.from_numpy(b).to(x.device))


def rf_map_apply(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Z = sqrt(2/D) cos(X W + b); x (n, d) fp32/bf16, w (d, D) fp32,
    b (D,) fp32, all contiguous. Returns (n, D) fp32."""
    device.require_matrix("rf_map", "x", x)
    device.require_matrix("rf_map", "w", w, (torch.float32,))
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"rf_map: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if not isinstance(b, torch.Tensor) or b.dtype != torch.float32 or \
            tuple(b.shape) != (w.shape[1],) or not b.is_contiguous():
        raise ValueError(f"rf_map: b must be a contiguous float32 "
                         f"({w.shape[1]},) tensor")
    if device.on_cpu("rf_map", x, w, b):
        return rf_map_ref(x, w, b)
    device.require_nonempty("rf_map", n=x.shape[0], d=x.shape[1],
                            D=w.shape[1])
    z = rf_map_cuda(x, w, b)
    LAUNCHES.add()
    return z
