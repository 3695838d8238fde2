"""Where a serving wave's time goes on the card: ``torch.profiler`` over
one prefill of BATCH x SEQ tokens (a wave of ``chip_smoke.py``'s serving
run) and over STEPS decode steps after it, on the architecture's
published configuration with random parameters from a generator seeded 0.

  python -m repro_torch.launch.profile_serve --arch recurrentgemma-9b

Prints one JSON line: for prefill and for decode, wall seconds under the
profiler, device-busy seconds (the union of kernel, memcpy and memset
intervals), the device's idle share, and the kernels by summed device
time. The profiler slows the host, so wall time here is longer than an
unprofiled run's. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.common.device import explicit_device
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models.model import DecoderLM

BATCH, SEQ, STEPS = 4, 4096, 8


def kernel_spans(prof) -> list:
    """(name, start us, duration us) of every kernel, memcpy and memset a
    profiler recorded, read from its chrome trace (the trace's categories
    tell device work from host ops and profiler overhead, which
    ``key_averages`` mixes in)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_us(spans) -> float:
    """Length of the union of the spans' intervals."""
    busy, end = 0.0, -math.inf
    for _, ts, dur in sorted(spans, key=lambda x: x[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy


def profile_wave(model: DecoderLM, batch: int, seq: int, steps: int,
                 seed: int = 2) -> dict:
    """Profile one warmed-up prefill of ``batch`` x ``seq`` random tokens,
    then ``steps`` greedy decode steps after a fresh prefill; returns
    {"prefill": ..., "decode": ...} as the module docstring describes."""
    from torch.profiler import ProfilerActivity, profile
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (batch, seq))).to(dev)
    out = {}
    with torch.inference_mode():
        model.prefill(toks, seq_len=seq + steps)       # warm-up
        for part in ("prefill", "decode"):
            if part == "decode":
                _, state = model.prefill(toks, seq_len=seq + steps)
                nxt = toks[:, -1:]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if part == "prefill":
                    model.prefill(toks, seq_len=seq + steps)
                else:
                    for _ in range(steps):
                        logits, state = model.decode_step(state, nxt)
                        nxt = logits.argmax(-1)[:, None]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            spans = kernel_spans(prof)
            busy = busy_us(spans) / 1e6
            by_name: dict = {}
            for name, _, dur in spans:
                ms, n = by_name.get(name, (0.0, 0))
                by_name[name] = (ms + dur / 1e3, n + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
            out[part] = {
                "steps": 1 if part == "prefill" else steps,
                "wall_s": wall, "device_busy_s": busy,
                "device_idle_share": 1.0 - busy / wall,
                "kernels": len(spans),
                "top_kernels_ms": [[k[:90], ms, n] for k, (ms, n) in top]}
            if part == "decode":
                del state
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    args = ap.parse_args(argv)

    dev = explicit_device("cuda", "repro_torch.launch.profile_serve")
    model = DecoderLM(get_config(args.arch), device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    res = profile_wave(model, BATCH, SEQ, STEPS)
    print(json.dumps({"arch": args.arch, "batch": BATCH, "seq": SEQ,
                      "device": torch.cuda.get_device_name(0), **res}),
          flush=True)


if __name__ == "__main__":
    main()
