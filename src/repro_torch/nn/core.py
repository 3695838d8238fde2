"""Parameter initialisers of the port's model stack.

Each takes the shape, an explicit ``torch.Generator`` where it draws, and
the device, and returns an fp32 tensor, as the JAX package keeps every
parameter in fp32 (``nn/core.py`` ``ParamSpec.dtype``) and casts it to the
compute dtype where an op uses it. The JAX package folds a key per
parameter path; the port draws from one generator in construction order.
The two never give the same numbers, so tests carry the JAX package's
parameters across (``repro_torch.interop.lm_params_from_reference``).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def normal(shape, std: float, generator: torch.Generator,
           device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def uniform(shape, lo: float, hi: float, generator: torch.Generator,
            device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(lo, hi, generator=generator)


def fan_in(shape, generator: torch.Generator, device,
           fan_axis: int = 0) -> torch.Tensor:
    """LeCun normal: stddev 1/sqrt(shape[fan_axis])."""
    fan = shape[fan_axis] if shape else 1
    return normal(shape, 1.0 / math.sqrt(max(fan, 1)), generator, device)


def parameter(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)
