"""Dry run of the port on one H100: build every supported (architecture x
input shape) at its full config on the meta device, run one step of it
there, and write the roofline inputs to results/dryrun/*.json.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The JAX package lowers and compiles each combo on fake TPU meshes and
reads XLA's memory and cost analysis. The port has one device and no
compiler between the model and the card, so the dry run is a build and
step check on meta tensors (shapes and dtypes, no data, no card): the
model is built at its published widths and depth, and one step runs
through every module and kernel wrapper (whose meta routes return empty
outputs of their kernels' shapes), so a shape fault anywhere on the path
raises here, on a machine without a GPU. Per combo:

  * train: the loss, its backward and one AdamW update;
  * prefill: a prefill of the batch;
  * decode: one serve step from a full cache (index S - 1).

Each JSON holds the parameter count (analytic and as built); the bytes of
the fp32 masters, gradients and AdamW states (train), or of the bf16
weights and the cache (prefill, decode); the bytes of the activations
autograd saves for the backward, counted with
``torch.autograd.graph.saved_tensors_hooks`` (each storage once; the bf16
weight casts it also saves are counted apart), which stands in for XLA's
``memory_analysis``; ``model_flops``; the H100 roofline terms
(``launch/roofline.py``); the bytes the port holds through the step,
whether that fits one card's 80 GB, and how many cards the state needs.

There is no mesh: ``--arch/--shape``, ``--all``, ``--out`` and
``--loss-chunk`` keep the JAX package's names; ``--multi-pod``,
``--test-mesh`` and ``--serve-layout`` (a TPU sharding) have no meaning on
one card, and ``--microbatches`` and ``--tag`` are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common.config import H100, SHAPES, TrainConfig
from repro_torch.configs import ASSIGNED, get_config, supports_shape
from repro_torch.launch import roofline as rl
from repro_torch.models import io as mio
from repro_torch.models.model import build_model
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optim import adamw_init, adamw_update, \
    master_params

OUT_DIR = "results/dryrun"


def combos() -> list[tuple[str, str]]:
    """Every supported (arch, shape) of ``ASSIGNED`` x ``SHAPES``, and the
    sliding-window dense variant at long_500k: the JAX package's
    ``--all``."""
    out = [(arch, name) for arch in ASSIGNED
           for name, shape in SHAPES.items()
           if supports_shape(get_config(arch), shape)]
    out.append(("qwen3-4b-sw", "long_500k"))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _is_weight(t: torch.Tensor) -> bool:
    """A parameter, or its cast to the compute dtype (a view of either):
    what the step holds anyway, not an activation."""
    base = t._base if t._base is not None else t
    if base.is_leaf:
        return base.requires_grad
    fn = base.grad_fn
    return type(fn).__name__ == "ToCopyBackward0" and any(
        type(nxt).__name__ == "AccumulateGrad"
        for nxt, _ in fn.next_functions)


class SavedTensors:
    """``saved_tensors_hooks`` that count the storage bytes autograd saves
    for the backward, each storage once, activations and weights apart."""

    def __init__(self):
        self.activations: dict[int, int] = {}
        self.weights: dict[int, int] = {}

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        (self.weights if _is_weight(t) else self.activations)[
            st._cdata] = st.nbytes()
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        lambda t: t)


def _cache_tensors(caches) -> list[torch.Tensor]:
    out = []
    for entry in caches:
        for c in (entry.values() if isinstance(entry, dict) else (entry,)):
            out += [x for x in vars(c).values()
                    if isinstance(x, torch.Tensor)]
    return out


def train_record(model, cfg, shape) -> dict:
    """One train step of ``model`` (built on meta) at ``shape``: the loss,
    its backward under the saved-tensor count, one AdamW update; returns
    the state, cast, saved and resident bytes and the bytes the step
    moves."""
    params = master_params(model)
    batch = mio.batch_struct(cfg, shape)
    saved = SavedTensors()
    with saved.hooks():
        loss, _, grads = value_and_grad(model, params, batch,
                                        cast_params=True)
    if loss.shape != () or any(grads[k].shape != p.shape
                               for k, p in params.items()):
        raise AssertionError(f"{cfg.name}: loss {tuple(loss.shape)} or a "
                             "gradient of the wrong shape")
    opt = adamw_init(params)
    adamw_update(grads, opt, params, TrainConfig())
    masters, grad_b = _nbytes(params.values()), _nbytes(grads.values())
    opt_b = _nbytes(opt["m"].values()) + _nbytes(opt["v"].values())
    cd = getattr(torch, cfg.dtype)
    casts = sum(p.numel() for p in params.values()) * cd.itemsize \
        if cd != torch.float32 else 0
    act = sum(saved.activations.values())
    state = masters + grad_b + opt_b
    return {"state_bytes": {"masters": masters, "gradients": grad_b,
                            "adamw_m_v": opt_b},
            "weight_casts_bytes": casts,
            "saved_activation_bytes": act,
            "saved_weight_bytes": sum(saved.weights.values()),
            # every state tensor read and written once, the casts written
            # and read once, each saved activation written and read once
            "bytes_per_device": 2 * (state + casts + act),
            # an estimate of the peak, neither floor nor ceiling: the
            # backward frees a layer's saved tensors and casts as that
            # layer's gradients appear, so the step never holds all of
            # it at once, and transients (a layer's recomputation, the
            # loss chunk's logits, AdamW's temporaries) come on top
            "resident_bytes": state + casts + act}


def _serve_state(model, caches) -> dict:
    cache_b = _nbytes(_cache_tensors(caches))
    as_built = _nbytes(model.parameters())
    weights_bf16 = 2 * sum(p.numel() for p in model.parameters())
    return {"state_bytes": {"weights_bf16": weights_bf16,
                            "cache": cache_b},
            "param_bytes_as_built": as_built,
            # the port serves from its fp32 parameters, cast per op
            "resident_bytes": as_built + cache_b}


def prefill_record(model, cfg, shape) -> dict:
    batch = mio.batch_struct(cfg, shape)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, state = model.prefill(batch["tokens"], **extras)
    if tuple(logits.shape) != (shape.global_batch, cfg.vocab_size):
        raise AssertionError(f"{cfg.name}: prefill logits "
                             f"{tuple(logits.shape)}")
    rec = _serve_state(model, state.caches)
    # read every bf16 weight once, write the cache once
    rec["bytes_per_device"] = sum(rec["state_bytes"].values())
    return rec


def decode_record(model, cfg, shape) -> dict:
    state = mio.decode_state_struct(model, shape)
    logits, _ = model.decode_step(state,
                                  mio.decode_tokens_struct(cfg, shape))
    if tuple(logits.shape) != (shape.global_batch, cfg.vocab_size):
        raise AssertionError(f"{cfg.name}: decode logits "
                             f"{tuple(logits.shape)}")
    rec = _serve_state(model, state.caches)
    rec["cache_bytes_analytic"] = rl.cache_bytes(cfg, shape)
    rec["bytes_per_device"] = rl.analytic_decode_bytes_per_chip(cfg, shape)
    return rec


def run_one(arch: str, shape_name: str, *, out_dir: str = OUT_DIR,
            verbose: bool = True, loss_chunk: int = 0) -> dict:
    """Build ``arch`` at its full config on the meta device, run one step
    of ``shape_name``'s mode, and return (and write under ``out_dir``,
    unless it is empty) its record."""
    cfg = get_config(arch)
    if loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    built = sum(p.numel() for p in model.parameters())
    if shape.mode == "train":
        rec = train_record(model, cfg, shape)
    else:
        step = prefill_record if shape.mode == "prefill" else decode_record
        with torch.inference_mode():
            rec = step(model, cfg, shape)
    seconds = time.perf_counter() - t0
    report = rl.build_report(arch, shape, cfg, rec["bytes_per_device"])
    state = sum(rec["state_bytes"].values())
    result = {
        "arch": arch, "shape": shape_name, "mode": shape.mode,
        "device": "meta", "card": H100.card, "chips": 1,
        "seconds": seconds,
        "param_count": {"analytic": rl.param_count(cfg), "built": built},
        "active_param_count": rl.active_param_count(cfg),
        **rec,
        "model_flops": report.model_flops,
        "roofline": report.to_dict(),
        "fits_one_card": rec["resident_bytes"] <= H100.hbm_bytes,
        "cards_for_state": math.ceil(state / H100.hbm_bytes),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_{shape_name}_h100.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    if verbose:
        r = report
        print(f"[dryrun] {arch} x {shape_name} on meta: {seconds:.1f}s, "
              f"{built / 1e9:.3f} B parameters, state "
              f"{state / 1e9:.1f} GB, resident "
              f"{rec['resident_bytes'] / 1e9:.1f} GB "
              f"({'fits' if result['fits_one_card'] else 'does not fit'} "
              f"one card; state on {result['cards_for_state']})")
        print(f"  roofline on {r.card}: compute {r.compute_s * 1e3:.2f}ms "
              f"| memory {r.memory_s * 1e3:.2f}ms -> dominant: "
              f"{r.dominant}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="run every supported (arch x shape)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help=">0: sequence-chunked unembed+xent")
    args = ap.parse_args(argv)

    if args.all:
        todo = combos()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in todo:
        try:
            run_one(arch, shape_name, out_dir=args.out,
                    loss_chunk=args.loss_chunk)
        except Exception:
            failures.append((arch, shape_name))
            traceback.print_exc()
    if failures:
        print(f"FAILED combos: {failures}")
        raise SystemExit(1)
    print(f"dry-run OK: {len(todo)} combos")


if __name__ == "__main__":
    main()
