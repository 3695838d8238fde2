"""Batched serving engine: aligned-batch prefill + decode with caches.

Continuous-batching-lite, as the JAX package's ``serve/engine.py``: a
fixed number of slots; queued requests are admitted in waves (a wave =
one aligned prefill of left-padded prompts), then decoded step-locked
until every member finishes (EOS or max_new_tokens). The port runs
eagerly (CUDA-graph capture of the decode step is ROADMAP A7/A8) and
synchronises the device before it stamps a time. A wave's modality
extras (a prefix-LM's ``patch_embeds``, an encoder-decoder's ``frames``)
come from ``run(extras_fn=)`` and go to the model's prefill.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                    # -1: never stops early
    out_tokens: Optional[list] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Serves ``model`` (a ``DecoderLM`` or ``EncDecLM``, parameters
    included) on the
    model's device. ``stats`` sums over waves as the JAX engine's does;
    ``waves`` keeps one record per wave."""

    def __init__(self, model, max_batch: int = 8, pad_id: int = 0):
        self.model = model
        self.max_batch = max_batch
        self.pad_id = pad_id
        self.queue: list[Request] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "requests": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}
        self.waves: list[dict] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.stats["requests"] += 1

    def _wave(self, reqs: list[Request],
              extras: Optional[dict] = None) -> None:
        dev = self.model.device
        max_len = max(len(r.prompt) for r in reqs)
        b = len(reqs)
        toks = np.full((b, max_len), self.pad_id, np.int64)
        for i, r in enumerate(reqs):
            toks[i, max_len - len(r.prompt):] = r.prompt     # left-pad
        max_new = max(r.max_new_tokens for r in reqs)
        total = max_len + max_new + (self.model.cfg.prefix_len or 0)
        tokens = torch.from_numpy(toks).to(dev)
        extras = {k: torch.as_tensor(v).to(dev)
                  for k, v in (extras or {}).items()}

        _sync(dev)
        t0 = time.perf_counter()
        logits, state = self.model.prefill(tokens, seq_len=total, **extras)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += prefill_s

        current = logits.argmax(dim=-1)
        done = np.zeros(b, bool)
        for r in reqs:
            r.out_tokens = []
        steps = 0
        t0 = time.perf_counter()
        for _ in range(max_new):
            cur_np = current.cpu().numpy()
            for i, r in enumerate(reqs):
                if not done[i]:
                    tok = int(cur_np[i])
                    r.out_tokens.append(tok)
                    if tok == r.eos_id or \
                            len(r.out_tokens) >= r.max_new_tokens:
                        done[i] = True
            if done.all():
                break
            logits, state = self.model.decode_step(state, current[:, None])
            steps += 1
            current = logits.argmax(dim=-1)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        self.stats["decode_steps"] += steps
        self.stats["decode_s"] += decode_s
        self.waves.append({"batch": b, "prompt_len": max_len,
                           "prefill_s": prefill_s, "decode_steps": steps,
                           "decode_s": decode_s,
                           "new_tokens": sum(len(r.out_tokens)
                                             for r in reqs)})

    def run(self, extras_fn=None) -> list[Request]:
        """Drain the queue in waves of up to max_batch. ``extras_fn(n)``
        gives a wave of ``n`` requests its modality inputs (name -> numpy
        array or tensor, moved to the model's device)."""
        finished = []
        while self.queue:
            wave = self.queue[: self.max_batch]
            self.queue = self.queue[self.max_batch:]
            extras = extras_fn(len(wave)) if extras_fn else None
            self._wave(wave, extras)
            finished.extend(wave)
        return finished
