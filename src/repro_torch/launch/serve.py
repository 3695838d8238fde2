"""Serving launcher: batched requests against a reduced model of the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --device cpu

The model is the architecture's reduced configuration with random
parameters from a generator seeded 0, as the JAX package's launcher does;
a prefix-LM's patch embeddings and an encoder-decoder's frames are drawn
for each wave as the JAX package's launcher draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import explicit_device
from repro_torch.configs import ALL_ARCHS, get_reduced
from repro_torch.models.io import stub_extras
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = explicit_device(args.device, "repro_torch.launch.serve")
    cfg = get_reduced(args.arch)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    engine = ServingEngine(model, max_batch=args.max_batch)
    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        engine.submit(Request(
            prompt=rng.randint(0, cfg.vocab_size,
                               rng.randint(4, 24)).astype(np.int32),
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run(extras_fn=lambda n: stub_extras(cfg, n, rng))
    dt = time.perf_counter() - t0
    new = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {new} tokens, {dt:.2f}s "
          f"({new / dt:.1f} tok/s) on {dev}; stats={engine.stats}")


if __name__ == "__main__":
    main()
