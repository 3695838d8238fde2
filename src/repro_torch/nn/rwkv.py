"""RWKV-6 "Finch" layer (arXiv:2404.05892): attention-free time-mix with
data-dependent per-channel decay, plus channel-mix FFN, as the JAX
package's ``nn/rwkv.py`` computes it.

Per head (head dim D), with r/k/v projections and decay w_t in (0,1)^D:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: D x D)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)    (u: per-channel bonus)

A full forward or a prefill runs the chunked formulation over chunks of
``CHUNK`` tokens (the intra-chunk part attention-style with decay masks,
the state carried from chunk to chunk), and decode the single step. The
intra-chunk decays are taken pair by pair (:func:`chunked_wkv`), where
the JAX package's factored, clipped exponents turn NaN for strong decays. The
JAX package takes the chunked form only when S is a multiple of
``CHUNK`` and otherwise walks every token; the port runs the chunked form
over the first ``(S // CHUNK) * CHUNK`` tokens and steps the tail from the
state they leave, the same recurrence, so a prompt of 4,020 tokens takes
31 chunks and 52 steps rather than 4,020 steps. Below one chunk both walk
every token. Everything is plain PyTorch (the JAX package computes WKV in
XLA, outside any Pallas kernel).

The layer owns both residual branches and their norms, as the reference
RWKV structure (and the JAX package's ``models/blocks.py``) has it, and
its parameters sit at its top level (``ln1.scale``, ``r.w``, ``w0``, ...),
the JAX package's ``rwkv_spec`` tree.

Data-dependent decay uses the Finch LoRA parameterization:
    w_t = exp(-exp(w0 + tanh(x_t A_w) B_w))
Token-shift mixing uses static per-channel mix coefficients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.nn.core import fan_in, normal, ones, parameter, uniform
from repro_torch.nn.linear import Weight
from repro_torch.nn.norms import RMSNorm

CHUNK = 128
LORA_DIM = 64
#: the norms' epsilon: the JAX package's ``rmsnorm_apply(..., 1e-5)``
NORM_EPS = 1e-5


@dataclasses.dataclass
class RWKVCache:
    state: torch.Tensor     # (B, H, Dk, Dv) fp32 wkv state
    last: torch.Tensor      # (B, d) previous normed token (time-mix shift)
    last_cm: torch.Tensor   # (B, d) previous normed token (channel-mix)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> previous-token tensor, seeded with ``last`` (B, d)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def chunked_wkv(r, k, v, w_log, u, s0):
    """Chunked linear attention with per-token per-channel decay; S must
    be a multiple of :data:`CHUNK`.

    r, k, v: (B, S, H, D); w_log: (B, S, H, D) log-decay (<= 0); u: (H, D);
    s0: (B, H, D, D) initial state. Returns (out (B, S, H, D), sT). fp32.

    Within a chunk, key j reaches query i > j decayed by exp(cum_{i-1} -
    cum_j) per channel, which the port takes pair by pair, masked before
    the exp, so every factor is at most 1. The JAX package factors it as
    exp(a_i) exp(b_j) with the exponents centred and clipped to +-60:
    once a chunk's decays sum past about -120 the factors of masked pairs
    overflow (inf times the mask's 0, NaN), and a pair whose two factors
    both clip weighs 1 where its decay is far below 1. Where the JAX
    package's chunked form is finite, the two agree to rounding.
    """
    b, s, h, dd = r.shape
    idx = torch.arange(CHUNK, device=r.device)
    later = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    state = s0
    outs = []
    for lo in range(0, s, CHUNK):
        rc, kc, vc, wc = (t[:, lo:lo + CHUNK] for t in (r, k, v, w_log))
        # the decay sums in float64: at strong decays a chunk's sums reach
        # thousands, where an fp32 difference cum_{i-1} - cum_j keeps only
        # about 1e-4 of a neighbour's exponent and the chunk falls past
        # 2e-4 of the token scan (the strong-decay test of
        # tests/test_torch_nn_families.py). The float64 difference is one
        # memory-bound pass; an fp32 form that sums each pair's decays on
        # their own (a cumsum over the (C, C) tensor) ran no faster on the
        # card.
        cum = torch.cumsum(wc.double(), dim=1)       # inclusive decay sums
        excl = cum - wc.double()                     # cum_{i-1}
        total = cum[:, -1]                           # (B, H, D)
        # (B, C_i, C_j, H, D): exp(cum_{i-1} - cum_j) for j < i, else 0
        decay = torch.exp((excl[:, :, None] - cum[:, None, :]).float()
                          .masked_fill(~later, -math.inf))
        scores = (rc[:, :, None] * kc[:, None] * decay).sum(-1)
        diag = torch.einsum("bihd,bihd->bhi", rc, u[None, None] * kc)
        intra = torch.einsum("bijh,bjhd->bihd", scores, vc)
        intra = intra + diag.transpose(1, 2)[..., None] * vc
        # the state enters query i with decay exp(cum_{i-1}) (<= 1)
        inter = torch.einsum("bihd,bhde->bihe",
                             rc * torch.exp(excl.float()), state)
        # S' = diag(exp(total)) S + sum_j exp(total - cum_j) k_j v_j^T
        k_dec = kc * torch.exp((total[:, None] - cum).float())
        state = torch.exp(total.float())[..., None] * state \
            + torch.einsum("bjhd,bjhe->bhde", k_dec, vc)
        outs.append(intra + inter)
    return torch.cat(outs, dim=1), state


def wkv_step(r, k, v, w_log, u, state):
    """One step. r, k, v, w_log: (B, H, D); state: (B, H, Dk, Dv)."""
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    out = torch.einsum("bhd,bhde->bhe", r, state + u[None, :, :, None] * kv)
    return out, torch.exp(w_log)[..., None] * state + kv


def wkv_scan(r, k, v, w_log, u, s0):
    """:func:`wkv_step` over every token of (B, S, H, D) inputs."""
    state = s0
    outs = []
    for t in range(r.shape[1]):
        o, state = wkv_step(r[:, t], k[:, t], v[:, t], w_log[:, t], u, state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


def wkv(r, k, v, w_log, u, s0):
    """The recurrence over (B, S, H, D) inputs from ``s0``: chunked over
    whole chunks, stepped over the tail. Returns (out, sT)."""
    s = r.shape[1]
    whole = s - s % CHUNK
    if whole == s:
        return chunked_wkv(r, k, v, w_log, u, s0)
    if whole == 0:
        return wkv_scan(r, k, v, w_log, u, s0)
    head, state = chunked_wkv(r[:, :whole], k[:, :whole], v[:, :whole],
                              w_log[:, :whole], u, s0)
    tail, state = wkv_scan(r[:, whole:], k[:, whole:], v[:, whole:],
                           w_log[:, whole:], u, state)
    return torch.cat([head, tail], dim=1), state


class RWKV(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        d, dh = cfg.d_model, cfg.rwkv_head_dim
        if d % dh:
            raise ValueError(f"d_model {d} is not a multiple of "
                             f"rwkv_head_dim {dh}")
        self.cfg = cfg

        def w(shape):
            return Weight(fan_in(shape, generator, device))
        self.ln1 = RMSNorm(d, NORM_EPS, device=device)
        self.ln2 = RMSNorm(d, NORM_EPS, device=device)
        # time-mix
        self.mix = parameter(uniform((4, d), 0.0, 1.0, generator, device))
        self.r, self.k, self.v, self.g = (w((d, d)) for _ in range(4))
        # decays near 1 at init (log-decay ~ -e^-4 .. -e^-1)
        self.w0 = parameter(uniform((d,), -4.0, -1.0, generator, device))
        self.w_a = parameter(normal((d, LORA_DIM), 0.01, generator, device))
        self.w_b = parameter(normal((LORA_DIM, d), 0.01, generator, device))
        self.u = parameter(uniform((d,), -0.5, 0.5, generator, device))
        self.out = w((d, d))
        self.ln_x_scale = parameter(ones((d,), device))
        # channel-mix
        self.cm_mix = parameter(uniform((2, d), 0.0, 1.0, generator, device))
        self.cm_k = w((d, cfg.d_ff))
        self.cm_v = w((cfg.d_ff, d))
        self.cm_r = w((d, d))

    def _time_mix(self, xn, cache: Optional[RWKVCache], cd):
        b, s, d = xn.shape
        dh = self.cfg.rwkv_head_dim
        h = d // dh
        last = cache.last.to(cd) if cache is not None else \
            torch.zeros((b, d), dtype=cd, device=xn.device)
        delta = _token_shift(xn, last) - xn
        mix = self.mix.to(cd)
        xr, xk, xv, xw = (xn + delta * mix[i] for i in range(4))
        r = xr @ self.r.w.to(cd)
        k = xk @ self.k.w.to(cd)
        v = xv @ self.v.w.to(cd)
        g = xr @ self.g.w.to(cd)
        lora = torch.tanh(xw @ self.w_a.to(cd)) @ self.w_b.to(cd)
        w_log = -torch.exp(torch.clamp(self.w0.float() + lora.float(),
                                       -8.0, 4.0))           # (B,S,d) <= 0

        rf, kf, vf, wf = (t.float().reshape(b, s, h, dh)
                          for t in (r, k, v, w_log))
        uf = self.u.float().reshape(h, dh)
        s0 = cache.state if cache is not None else \
            torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=xn.device)
        if s == 1 and cache is not None:
            out, s_new = wkv_step(rf[:, 0], kf[:, 0], vf[:, 0], wf[:, 0],
                                  uf, s0)
            out = out[:, None]
        else:
            out, s_new = wkv(rf, kf, vf, wf, uf, s0)

        # group norm over each head, then the output gate
        mean = out.mean(dim=-1, keepdim=True)
        var = (out - mean).square().mean(dim=-1, keepdim=True)
        out = ((out - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
        out = out * self.ln_x_scale.float()
        y = out.to(cd) * F.silu(g)
        return y @ self.out.w.to(cd), s_new

    def _channel_mix(self, xn, cache: Optional[RWKVCache], cd):
        b, _, d = xn.shape
        last = cache.last_cm.to(cd) if cache is not None else \
            torch.zeros((b, d), dtype=cd, device=xn.device)
        delta = _token_shift(xn, last) - xn
        cmix = self.cm_mix.to(cd)
        xk = xn + delta * cmix[0]
        xr = xn + delta * cmix[1]
        k = torch.square(F.relu(xk @ self.cm_k.w.to(cd)))
        v = k @ self.cm_v.w.to(cd)
        return torch.sigmoid(xr @ self.cm_r.w.to(cd)) * v

    def forward(self, x: torch.Tensor, *, cache: Optional[RWKVCache] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """The whole layer on the raw residual stream (B, S, d): a full
        forward (no cache), a prefill from ``cache``'s state (S > 1), or
        one decode step (S == 1 with a cache). Returns (new x, new cache
        or None)."""
        if x.device.type == "cpu":
            settle_cpu_vector_math()
        x = x.to(compute_dtype)
        xn1 = self.ln1(x)
        y_tm, s_new = self._time_mix(xn1, cache, compute_dtype)
        x = x + y_tm
        xn2 = self.ln2(x)
        x = x + self._channel_mix(xn2, cache, compute_dtype)
        new_cache = None
        if cache is not None:
            new_cache = RWKVCache(state=s_new, last=xn1[:, -1].float(),
                                  last_cm=xn2[:, -1].float())
        return x, new_cache
