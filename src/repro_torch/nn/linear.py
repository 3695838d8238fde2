"""Weight holders, the embedding and the unembedding."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.core import parameter


class Weight(nn.Module):
    """One weight ``w``: the JAX package's ``{"w": ...}`` subtree. Callers
    cast it to their compute dtype where they use it."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = parameter(w)


class Embedding(nn.Module):
    """A (vocab, d_model) table ``embedding``: the input embedding, and the
    unembedding (untied ``lm_head``, or the tied input table)."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.embedding = parameter(table)

    def embed(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Rows of the table in ``dtype`` (the rows are cast, not the
        table: the same values as casting first)."""
        return self.embedding[ids.long()].to(dtype)

    def unembed(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Logits (..., V) = x (..., d) @ table^T, in ``dtype``."""
        return x.to(dtype) @ self.embedding.to(dtype).T
