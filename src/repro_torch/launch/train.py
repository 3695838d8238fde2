"""Training launcher of the port: real runs on the chosen device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-9b \\
      --reduced --steps 30 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-9b \\
      --reduced --steps 5 --device cpu

The JAX package's flags, plus ``--device`` (default cuda, which raises
without CUDA). Parameters are random from a generator seeded 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.common.device import explicit_device
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import make_train_step
from repro_torch.train.optim import adamw_init, master_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = explicit_device(args.device, "repro_torch.launch.train")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    params = master_params(model)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        mode="train")
    data = SyntheticLM(cfg, shape, seed=0, bigram_q=0.7)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=5,
                     total_steps=args.steps)
    opt = adamw_init(params)
    step_fn = make_train_step(model, tc)

    t0 = time.perf_counter()
    for step in range(args.steps):
        params, opt, metrics = step_fn(params, opt,
                                       to_device(data.batch(step), dev))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt, step=args.steps)
        print(f"saved -> {args.ckpt}")


if __name__ == "__main__":
    main()
