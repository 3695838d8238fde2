"""Gated (SwiGLU/GeGLU) and plain MLP blocks."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.nn.core import fan_in
from repro_torch.nn.linear import Weight

# jax.nn.gelu approximates with tanh by default, so "gelu" does too
ACTS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = ACTS[cfg.act]
        self.up = Weight(fan_in((d, f), generator, device))
        self.down = Weight(fan_in((f, d), generator, device))
        self.gate = Weight(fan_in((d, f), generator, device)) \
            if cfg.glu else None

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        x = x.to(compute_dtype)
        up = x @ self.up.w.to(compute_dtype)
        if self.gate is not None:
            h = self.act(x @ self.gate.w.to(compute_dtype)) * up
        else:
            h = self.act(up)
        return h @ self.down.w.to(compute_dtype)
