"""The JAX package's ``common/pytree.py`` helpers that training needs, over
the port's parameter trees: flat dicts of name -> tensor (a state dict)."""
from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32, on the tensors'
    device (no host read-back)."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cast_floating(tree: dict, dtype: torch.dtype) -> dict:
    """Floating tensors cast to ``dtype`` (differentiably: a gradient of the
    cast reaches the original in its own type); others as they are."""
    return {k: x.to(dtype) if x.is_floating_point() else x
            for k, x in tree.items()}
