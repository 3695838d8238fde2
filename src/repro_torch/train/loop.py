"""The train step and the training loop used by ``launch/train.py``.

The JAX package's ``train/loop.py`` in eager PyTorch: ``jax.value_and_grad``
of ``model.loss`` becomes ``torch.autograd.grad`` of :meth:`DecoderLM.loss`
run through ``torch.func.functional_call`` on the step's parameter dict,
``lax.scan`` over microbatches a Python loop, and nothing is jitted or
captured.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import cast_floating
from repro_torch.train.optim import adamw_init, adamw_update, project_grads


class _Loss(nn.Module):
    """``model.loss`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.loss(batch)


def value_and_grad(model, params: dict, batch: dict,
                   cast_params: bool = False) -> tuple:
    """``jax.value_and_grad(model.loss, has_aux=True)`` of the port:
    (loss, {"nll", "aux"}, grads) of ``model.loss(batch)`` run on
    ``params`` (name -> tensor that requires a gradient; with
    ``cast_params`` cast to the model's compute dtype first, the
    gradients still of ``params`` in their own type). A parameter the
    loss does not reach gets zeros, as in JAX."""
    p = cast_floating(params, model.compute_dtype) if cast_params \
        else params
    loss, metrics = torch.func.functional_call(
        _Loss(model), {f"model.{k}": v for k, v in p.items()}, (batch,))
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(params, grads))


def make_train_step(model, tc: TrainConfig, galore_state=None,
                    microbatches: int = 1,
                    cast_params: bool = True) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), where ``params`` are the fp32 masters (name -> leaf tensor
    that requires a gradient, e.g. ``optim.master_params(model)``),
    updated in place.

    * ``cast_params``: mixed precision — the model runs on copies of the
      masters cast to its compute dtype at the top of the step
      (``torch.func.functional_call``), and the gradients land on the fp32
      masters;
    * ``microbatches`` > 1: gradient accumulation over equal slices of
      the batch, fp32 gradient sums, then their mean;
    * ``galore_state``: low-rank gradient projection with offload-refreshed
      projectors (the Alchemist SVD service).
    """
    def grads_of(params, batch):
        return value_and_grad(model, params, batch, cast_params)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"a batch of {rows} does not split into "
                                 f"{microbatches} equal microbatches")
            n = rows // microbatches
            loss = None
            grads = None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mloss, _metrics, mgrads = grads_of(params, mb)
                loss = mloss if loss is None else loss + mloss
                if grads is None:
                    grads = {k: g.float() for k, g in mgrads.items()}
                else:
                    for k, g in mgrads.items():
                        grads[k].add_(g.float())
                del mgrads
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if galore_state is not None:
            grads = project_grads(grads, galore_state)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, tc)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return params, opt_state, metrics

    return train_step


def train(model, params: dict, batches, tc: TrainConfig,
          hooks: Optional[list[Callable]] = None,
          log_every: int = 10) -> tuple[dict, list[dict]]:
    """Simple host loop: iterate batches, run hooks (checkpoint, GaLore
    refresh, eval) between steps. Returns (params, history); metrics are
    read back to the host only at the logged steps."""
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, tc)
    history = []
    t0 = time.perf_counter()
    for step, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if hooks:
            for hook in hooks:
                out = hook(step, params, opt_state, metrics)
                if out is not None:
                    params, opt_state = out
        if step % log_every == 0 or step == tc.total_steps - 1:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            metrics["elapsed_s"] = time.perf_counter() - t0
            history.append(metrics)
    return params, history
