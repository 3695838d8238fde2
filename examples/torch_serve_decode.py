"""Serving example on the PyTorch port (``repro_torch``): batched requests
through the prefill+decode engine with KV caches (the decode path that
the decode_32k / long_500k dry-run shapes lower at production scale).

    PYTHONPATH=src python examples/torch_serve_decode.py [--arch qwen3-4b] \
        [--device cpu]

Any assigned architecture at its reduced config, random parameters from a
generator seeded 0; a prefix-VLM gets stub patch embeddings and an
encoder-decoder stub frame embeddings per wave. The model runs on one
CUDA card by default; ``--device cpu`` runs it on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import explicit_device
from repro_torch.configs import ALL_ARCHS, get_reduced
from repro_torch.models.io import stub_extras
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine


def serve(model, requests: int, max_new: int, seed: int = 0) -> tuple:
    """The example's traffic on ``model``: ``requests`` prompts of 4-19
    random tokens from ``RandomState(seed)``, ``max_new`` new tokens each,
    waves of 4, the stub modality inputs drawn per wave from the same
    generator. Returns (the finished requests, the engine, seconds)."""
    cfg = model.cfg
    engine = ServingEngine(model, max_batch=4)
    rng = np.random.RandomState(seed)
    for _ in range(requests):
        plen = rng.randint(4, 20)
        engine.submit(Request(
            prompt=rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=max_new))
    t0 = time.perf_counter()
    done = engine.run(extras_fn=lambda n: stub_extras(cfg, n, rng))
    return done, engine, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = explicit_device(args.device, "torch_serve_decode")
    model = build_model(get_reduced(args.arch), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    done, engine, dt = serve(model, args.requests, args.max_new)
    total_new = sum(len(r.out_tokens) for r in done)
    print(f"arch={args.arch}: served {len(done)} requests, {total_new} new "
          f"tokens in {dt:.2f}s on {dev}")
    print(f"stats: {engine.stats}")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt[{len(r.prompt)}] -> {r.out_tokens}")


if __name__ == "__main__":
    main()
