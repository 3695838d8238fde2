"""RMSNorm / LayerNorm, in fp32 whatever the input type."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.core import ones, parameter, zeros


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device):
        super().__init__()
        self.eps = eps
        self.scale = parameter(ones((dim,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device):
        super().__init__()
        self.eps = eps
        self.scale = parameter(ones((dim,), device))
        self.bias = parameter(zeros((dim,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


def norm(dim: int, use_layernorm: bool, eps: float, *, device) -> nn.Module:
    cls = LayerNorm if use_layernorm else RMSNorm
    return cls(dim, eps, device=device)
