"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block structure (the paper's "recurrent block"):
    x -> [linear -> causal depthwise conv1d -> RG-LRU] * gelu(linear gate) -> linear out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                 (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)       (data-dependent decay, c=8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates, the conv and the single decode step are plain PyTorch, as the
JAX package computes them in XLA. A full forward or a prefill runs the
recurrence through ``kernels.lru_scan`` (the CUDA kernel on the card) from
h0, zeros without a cache: the function the JAX package computes with
``jax.lax.associative_scan`` after folding h0 into the first input. Under
autograd (training) that is the kernel's ``torch.autograd.Function``,
whose backward runs the adjoint recurrence through the same kernel
launched in reverse, so the gates, the conv and ``lam`` get their
gradients on the card as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.nn.core import fan_in, parameter, uniform, zeros
from repro_torch.nn.linear import Weight

_C = 8.0


@dataclasses.dataclass
class RGLRUCache:
    h: torch.Tensor         # (B, W) recurrent state (fp32)
    conv: torch.Tensor      # (B, conv_width-1, W) conv tail buffer


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        cw = cfg.conv1d_width
        self.in_x = Weight(fan_in((d, w), generator, device))
        self.in_gate = Weight(fan_in((d, w), generator, device))
        self.conv_w = parameter(fan_in((cw, w), generator, device))
        self.conv_b = parameter(zeros((w,), device))
        self.gate_a = Weight(fan_in((w, w), generator, device))
        self.gate_a_b = parameter(zeros((w,), device))
        self.gate_x = Weight(fan_in((w, w), generator, device))
        self.gate_x_b = parameter(zeros((w,), device))
        # Lambda init so that decay a in ~(0.9, 0.999) at r=1
        self.lam = parameter(uniform((w,), 0.549, 4.833, generator, device))
        self.out = Weight(fan_in((w, d), generator, device))

    def _gates(self, xw: torch.Tensor, compute_dtype: torch.dtype):
        """xw: (..., W) conv output -> (a, gated input), both fp32."""
        r = torch.sigmoid((xw @ self.gate_a.w.to(compute_dtype)).float()
                          + self.gate_a_b)
        i = torch.sigmoid((xw @ self.gate_x.w.to(compute_dtype)).float()
                          + self.gate_x_b)
        log_a = -_C * F.softplus(self.lam) * r            # log decay <= 0
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12))
        return a, beta * (i * xw.float())

    def _causal_conv(self, x: torch.Tensor, tail: Optional[torch.Tensor],
                     compute_dtype: torch.dtype):
        """Depthwise causal conv1d. x: (B, S, W); tail: (B, cw-1, W)."""
        cw = self.conv_w.shape[0]
        if tail is None:
            pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
        else:
            pad = tail.to(x.dtype)
        xp = torch.cat([pad, x], dim=1)                    # (B, S+cw-1, W)
        w = self.conv_w.to(compute_dtype)
        out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
        out = out + self.conv_b.to(compute_dtype)
        return out, xp[:, -(cw - 1):, :]

    def forward(self, x: torch.Tensor, *,
                cache: Optional[RGLRUCache] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """x: (B, S, d). Returns (y, new cache or None)."""
        if x.device.type == "cpu":
            settle_cpu_vector_math()
        b, s, _ = x.shape
        x = x.to(compute_dtype)
        xb = x @ self.in_x.w.to(compute_dtype)
        gate = x @ self.in_gate.w.to(compute_dtype)

        tail = cache.conv if cache is not None else None
        xw, new_tail = self._causal_conv(xb, tail, compute_dtype)
        a, gated = self._gates(xw, compute_dtype)

        if s == 1 and cache is not None:
            # decode: one step
            hs = (a[:, 0] * cache.h + gated[:, 0])[:, None, :]
        else:
            h0 = cache.h.contiguous() if cache is not None else \
                torch.zeros((b, xb.shape[-1]), dtype=torch.float32,
                            device=x.device)
            hs = lru_scan(a, gated, h0)

        y = (hs * F.gelu(gate.float(), approximate="tanh")) \
            .to(compute_dtype) @ self.out.w.to(compute_dtype)
        new_cache = RGLRUCache(h=hs[:, -1].contiguous(),
                               conv=new_tail.float()) \
            if cache is not None else None
        return y, new_cache
