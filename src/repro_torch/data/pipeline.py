"""Synthetic data pipeline: deterministic LM batches.

Tokens follow a Zipf-like marginal with a planted bigram structure so that
training actually reduces loss (pure-uniform tokens would pin loss at
log V). Each batch is reproducible from (seed, step): the data layer's
analogue of RDD lineage.

A copy of the JAX package's ``data/pipeline.py``: :meth:`SyntheticLM.batch`
is the same numpy ``RandomState`` code, so a batch is bit-identical to the
JAX package's for the same (config, shape, seed, step). :meth:`batches`
puts each batch on an explicit device, where the JAX package places it by
sharding rules. A prefix-LM's batch also holds ``patch_embeds`` and its
text is shortened by the prefix; an encoder-decoder's holds ``frames``:
both fp32 numpy arrays, drawn after the tokens from the same
``RandomState``.
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
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.q = bigram_q
        rng = np.random.RandomState(seed)
        self.perm = rng.permutation(cfg.vocab_size)
        self.probs = _zipf_probs(cfg.vocab_size)

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (B, S) int32 numpy arrays (S less a
        prefix-LM's prefix), and fp32 ``patch_embeds`` (B, P, d) or
        ``frames`` (B, encoder_seq, d_enc)."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.RandomState(self.seed + 100_003 * (step + 1))
        b = shape.global_batch
        s = shape.seq_len - (cfg.prefix_len or 0)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.probs)
        zipf = rng.choice(cfg.vocab_size, size=(b, s), p=self.probs)
        follow = rng.rand(b, s) < self.q
        for t in range(s):
            toks[:, t + 1] = np.where(follow[:, t], self.perm[toks[:, t]],
                                      zipf[:, t])
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.prefix_len:
            out["patch_embeds"] = (0.02 * rng.randn(
                b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        if cfg.is_encdec:
            out["frames"] = (0.02 * rng.randn(
                b, cfg.encoder_seq, cfg.encoder_d_model or cfg.d_model)
            ).astype(np.float32)
        return out

    def batches(self, steps: int, device="cuda") -> Iterator[dict]:
        """Batches 0 .. steps - 1 as tensors on ``device`` (default cuda,
        which raises without CUDA)."""
        dev = explicit_device(device, "SyntheticLM.batches")
        for step in range(steps):
            yield to_device(self.batch(step), dev)


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
