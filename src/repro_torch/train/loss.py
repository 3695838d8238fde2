"""Losses: softmax cross-entropy over (B, S, V) logits, and a chunked
unembed + cross-entropy that never holds more than one sequence chunk's
logits.

The counterpart of the JAX package's ``train/loss.py``. There the
reductions run over vocab-sharded logits; on one card the chunked variant
is what keeps the (B, S, V) logits of a 256,000-word vocabulary out of
memory: each chunk's logits are recomputed in the backward pass
(``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``), so
peak live logits are (B, chunk, V) in the gradient too.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _nll_sum(lf: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Sum over valid positions of logsumexp(lf) - lf[label], fp32."""
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1,
                               labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(valid, lse - label_logit, 0.0).sum()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """logits: (B, S, V) (any float dtype), labels: (B, S) int. Labels < 0
    are ignored. Returns the scalar mean nll (fp32)."""
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask
    total = _nll_sum(logits.float(), labels, valid)
    return total / valid.sum().clamp_min(1)


def _chunk_nll(xc: torch.Tensor, emb: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    lf = (xc.to(emb.dtype) @ emb.T).float()
    return _nll_sum(lf, lc, lc >= 0)


def chunked_unembed_cross_entropy(
    x: torch.Tensor,            # (B, S, d) final hidden states
    embedding: torch.Tensor,    # (V, d) unembedding matrix
    labels: torch.Tensor,       # (B, S) int, < 0 ignored
    seq_chunk: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Fused unembed + cross-entropy over sequence chunks: peak live logits
    are (B, seq_chunk, V) instead of (B, S, V), in the backward pass too
    (each chunk's logits are recomputed there). S not a multiple of
    ``seq_chunk`` runs as one chunk, as the JAX package falls back."""
    s = x.shape[1]
    if s % seq_chunk:
        seq_chunk = s
    emb = embedding.to(compute_dtype)
    total = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, seq_chunk):
        xc = x[:, lo:lo + seq_chunk]
        lc = labels[:, lo:lo + seq_chunk]
        total = total + checkpoint(_chunk_nll, xc, emb, lc,
                                   use_reentrant=False)
    return total / (labels >= 0).sum().clamp_min(1)
