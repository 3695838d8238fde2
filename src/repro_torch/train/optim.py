"""Optimizers: AdamW (fp32 states keyed by parameter name) and the
GaLore-style low-rank projection whose projector is refreshed by the
*offloaded* randomized SVD — the paper's §4.2 routine serving the trainer.

The JAX package's ``train/optim.py`` over the port's parameter dicts (name
-> tensor, ``layers.{n}.<path>``). Two differences of form, none of
arithmetic:

* :func:`adamw_update` updates the parameters and the states in place and
  returns them (the JAX package returns new trees): at RecurrentGemma-9B's
  widths new copies of parameters, ``m`` and ``v`` would not fit beside
  the old ones on one card;
* the JAX package stacks a segment's layers into 3-D parameters and keeps
  one projector per layer inside a 3-D projector; the port's parameters
  are per layer, so each eligible 2-D ``layers.{n}.<path>`` gets its own
  projector. The JAX package's 4-D stacks (attention's (d, heads, head
  dim) per layer) are not eligible there, and their 3-D per-layer
  counterparts are not here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import global_norm
from repro_torch.core.layout_tag import untag


def lr_schedule(tc: TrainConfig, step) -> float:
    """Linear warmup + cosine decay, in float32 as the JAX package
    computes it."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(tc.warmup_steps, 1)), f32(1.0))
    frac = np.clip((step - f32(tc.warmup_steps))
                   / f32(max(tc.total_steps - tc.warmup_steps, 1)),
                   f32(0), f32(1))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
    return float(f32(tc.learning_rate) * warm * (f32(0.1) + f32(0.9) * cos))


def adamw_init(params: dict) -> dict:
    """{"m", "v": fp32 zeros keyed like ``params``, "step": 0}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict,
                 tc: TrainConfig) -> tuple[dict, dict, dict]:
    """One AdamW step: clip by global norm, bias correction, decoupled
    weight decay. Updates ``params`` and ``state`` in place; returns
    (params, state, metrics {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(tc, step)
    bc1 = 1 - tc.b1 ** step
    bc2 = 1 - tc.b2 ** step
    # the JAX package's arithmetic, operation for operation, with at most
    # three temporaries of a parameter's size at a time
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(tc.b1).add_(g * (1 - tc.b1))
        v.mul_(tc.b2).add_(g.square_().mul_(1 - tc.b2))
        denom = torch.div(v, bc2, out=g).sqrt_().add_(tc.eps)
        delta = torch.div(m, bc1).div_(denom)
        del g, denom
        delta.add_(p.float() * tc.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# GaLore with Alchemist-offloaded projector refresh
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GaLoreState:
    """Projectors for each eligible parameter (name -> P of shape
    (rows, r))."""

    projectors: dict[str, torch.Tensor]
    rank: int


def eligible_for_galore(name: str, t: torch.Tensor, rank: int) -> bool:
    """A 2-D parameter whose sides both exceed 4 x rank."""
    return t.dim() == 2 and min(t.shape) > 4 * rank


def refresh_projectors(ac, grads: dict, rank: int,
                       seed: int = 0) -> GaLoreState:
    """Top-``rank`` left singular bases of each eligible gradient via the
    *offloaded* randomized SVD (engine-side; the client ships the gradient
    and receives the small basis — the Alchemist pattern). The projector
    is the engine's U, on the engine's device."""
    projectors: dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        if not eligible_for_galore(name, g, rank):
            continue
        al = ac.send_matrix(g.detach().float())
        res = ac.call("elemental", "randomized_svd", A=al, k=rank,
                      seed=seed)
        projectors[name] = untag(ac.engine.get(res["U"]))[0]
        al.free()
    return GaLoreState(projectors=projectors, rank=rank)


def project_grads(grads: dict, gal: GaLoreState) -> dict:
    """g -> P P^T g: rank-r column-space compression of each eligible grad
    (applied before the optimizer; states stay full-shape)."""
    out = {}
    for name, g in grads.items():
        p = gal.projectors.get(name)
        out[name] = g if p is None else \
            (p @ (p.T @ g.float())).to(g.dtype)
    return out


def master_params(model: torch.nn.Module) -> dict:
    """The model's parameters as the train step's fp32 masters: leaves that
    require a gradient and share storage with the model's own parameters,
    so the model holds what the optimizer writes (no copy of the
    weights)."""
    out = {}
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise TypeError(f"{name}: masters are fp32, got {p.dtype}")
        out[name] = p.detach().requires_grad_(True)
    return out
