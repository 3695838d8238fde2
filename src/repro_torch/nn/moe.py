"""Mixture-of-Experts (DeepSeek-V2 style: shared + routed experts, top-k),
as the JAX package's ``nn/moe.py`` computes it on one device.

Routing takes an fp32 softmax over the router's logits, the top-k experts
(ties to the lower index, as ``jax.lax.top_k``) and their probabilities
renormalised as gates, and the Switch/GShard load-balance loss. Dispatch
is capacity-based gather/scatter: each (token, choice) pair takes the next
slot of its expert in token order, pairs past the expert's capacity are
dropped, the experts run as batched products over their (E, C, d) slots,
and the gated outputs are summed back per token with ``index_add``. The
shared experts are one gated MLP over every token. All plain PyTorch; the
JAX package's expert parallelism (``shard_map`` over a 'model' mesh axis)
has no counterpart on one device, where it runs this same unsharded path.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.nn.core import fan_in, parameter
from repro_torch.nn.linear import Weight
from repro_torch.nn.mlp import MLP


def capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: capacity_factor times an
    even share, at least 8, rounded up to a multiple of 8."""
    c = int(n_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def route(x_flat: torch.Tensor, router_w: torch.Tensor, m: MoEConfig,
          compute_dtype) -> tuple:
    """(top ids (N, k) int64, gates (N, k) fp32, aux) of tokens (N, d)."""
    logits = (x_flat.to(compute_dtype)
              @ router_w.to(compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order,
    # as jax.lax.top_k does
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_ids = top_p[:, :m.top_k], top_ids[:, :m.top_k]
    gates = top_p / top_p.sum(dim=-1, keepdim=True)
    e = m.num_experts
    dispatch_frac = F.one_hot(top_ids, e).float().sum(dim=1).mean(dim=0) \
        / m.top_k
    aux = e * torch.sum(dispatch_frac * probs.mean(dim=0))
    return top_ids, gates, aux


def slots(top_ids: torch.Tensor, num_experts: int, cap: int) -> torch.Tensor:
    """Each (token, choice) pair's slot ``expert * cap + position``, in
    token order, or ``num_experts * cap`` where its expert is full
    (dropped). top_ids (N, k) -> (N * k,)."""
    flat = top_ids.reshape(-1)
    onehot = F.one_hot(flat, num_experts)                  # (N*k, E)
    pos = (torch.cumsum(onehot, dim=0) - onehot).mul_(onehot).sum(dim=1)
    return torch.where(pos < cap, flat * cap + pos, num_experts * cap)


def dispatch_compute(x_flat: torch.Tensor, top_ids: torch.Tensor,
                     gates: torch.Tensor, gate_w: torch.Tensor,
                     up_w: torch.Tensor, down_w: torch.Tensor, cap: int,
                     compute_dtype) -> torch.Tensor:
    """The routed experts' gated output (N, d) for tokens (N, d)."""
    n, k = top_ids.shape
    e = gate_w.shape[0]
    slot = slots(top_ids, e, cap)
    token_row = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    # one more slot than the experts hold takes every dropped pair
    idx = torch.full((e * cap + 1,), n, dtype=torch.long,
                     device=x_flat.device)
    idx = idx.index_put((slot,), token_row)[:-1]           # n: empty slot
    slot_gate = torch.zeros(e * cap + 1, dtype=torch.float32,
                            device=x_flat.device)
    slot_gate = slot_gate.index_put((slot,), gates.reshape(-1))[:-1]

    cd = compute_dtype
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, x_flat.shape[1]))])
    xe = x_pad[idx].reshape(e, cap, -1).to(cd)
    h = F.silu(torch.bmm(xe, gate_w.to(cd))) * torch.bmm(xe, up_w.to(cd))
    ye = torch.bmm(h, down_w.to(cd)).reshape(e * cap, -1)
    ye = ye * slot_gate[:, None].to(ye.dtype)
    out = torch.zeros((n + 1, ye.shape[1]), dtype=ye.dtype,
                      device=ye.device).index_add(0, idx, ye)
    return out[:n]


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        m: MoEConfig = cfg.moe
        d, f, e = cfg.d_model, m.expert_ff, m.num_experts
        self.cfg = cfg
        self.router = Weight(fan_in((d, e), generator, device))
        # fan-in over d (gate, up) and f (down), the JAX package's axis 1
        self.gate_w = parameter(fan_in((e, d, f), generator, device, 1))
        self.up_w = parameter(fan_in((e, d, f), generator, device, 1))
        self.down_w = parameter(fan_in((e, f, d), generator, device, 1))
        # the shared experts: one gated MLP of their summed width
        self.shared = MLP(dataclasses.replace(
            cfg, d_ff=f * m.num_shared_experts, glu=True),
            generator=generator, device=device) \
            if m.num_shared_experts else None

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> tuple:
        """x: (B, S, d). Returns (y, aux): aux the load-balance loss times
        ``router_aux_weight`` (a scalar fp32 tensor)."""
        m: MoEConfig = self.cfg.moe
        if x.device.type == "cpu":
            settle_cpu_vector_math()
        b, s, d = x.shape
        x = x.to(compute_dtype)
        x_flat = x.reshape(b * s, d)
        top_ids, gates, aux = route(x_flat, self.router.w, m, compute_dtype)
        y = dispatch_compute(x_flat, top_ids, gates, self.gate_w, self.up_w,
                             self.down_w, capacity(b * s, m), compute_dtype)
        y = y.reshape(b, s, d)
        if self.shared is not None:
            y = y + self.shared(x, compute_dtype)
        return y, aux * m.router_aux_weight
