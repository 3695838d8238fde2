"""Rotary position embeddings, supporting position offsets for decode, and
the sinusoidal position embeddings of an encoder."""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (B, S, Dh/2)
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings (S, D) fp32: sin over
    the first half, cos over the second, frequencies
    exp(-ln(10000) i / (D/2 - 1)) (the JAX package's ``half - 1``
    denominator)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(half, dtype=torch.float32, device=device)
                    / (half - 1))
    ang = pos * inv[None, :]
    return torch.cat([ang.sin(), ang.cos()], dim=-1)
