"""Synthetic data pipeline: deterministic LM batches.

Tokens follow a Zipf-like marginal with a planted bigram structure so that
training actually reduces loss (pure-uniform tokens would pin loss at
log V). Each batch is reproducible from (seed, step): the data layer's
analogue of RDD lineage.

A copy of the JAX package's ``data/pipeline.py``: :meth:`SyntheticLM.batch`
is the same numpy ``RandomState`` code, so a batch is bit-identical to the
JAX package's for the same (config, shape, seed, step). :meth:`batches`
puts each batch on an explicit device, where the JAX package places it by
sharding rules. Prefix (VLM) and encoder-decoder fields come with ROADMAP
A11c.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.common.device import explicit_device


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return p / p.sum()


class SyntheticLM:
    """Markov-ish synthetic corpus: next token depends on the current token
    through a fixed permutation with probability q, else Zipf sample."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 bigram_q: float = 0.5):
        for what, present in (("a prefix-LM (VLM) prefix", cfg.prefix_len),
                              ("encoder-decoder frames", cfg.is_encdec)):
            if present:
                raise NotImplementedError(
                    f"{cfg.name}: {what} is not in the port's data "
                    "pipeline yet (ROADMAP A11c)")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.q = bigram_q
        rng = np.random.RandomState(seed)
        self.perm = rng.permutation(cfg.vocab_size)
        self.probs = _zipf_probs(cfg.vocab_size)

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (B, S) int32 numpy arrays."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.RandomState(self.seed + 100_003 * (step + 1))
        b = shape.global_batch
        s = shape.seq_len
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.probs)
        zipf = rng.choice(cfg.vocab_size, size=(b, s), p=self.probs)
        follow = rng.rand(b, s) < self.q
        for t in range(s):
            toks[:, t + 1] = np.where(follow[:, t], self.perm[toks[:, t]],
                                      zipf[:, t])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def batches(self, steps: int, device="cuda") -> Iterator[dict]:
        """Batches 0 .. steps - 1 as int32 tensors on ``device`` (default
        cuda, which raises without CUDA)."""
        dev = explicit_device(device, "SyntheticLM.batches")
        for step in range(steps):
            yield to_device(self.batch(step), dev)


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
