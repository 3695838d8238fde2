"""The layout tag that follows a tensor out of the engine and back in.

The JAX engine reads a store's layout from its array's sharding
(``layout_of``), and an array computed from an engine array carries the
sharding XLA propagates to it. A torch tensor carries no sharding, so the
port's public ``AlchemistEngine.get`` hands out a :class:`LayoutTensor`:
the store's tensor itself (a view, no copy) tagged with the layout it
carries. A result takes the tag of the op's first argument (or of the
first tensor in a first-argument list, as ``torch.cat`` takes) when that
argument is tagged and the result has its rank; any other result is a
plain tensor. At one worker that is the layout the JAX engine derives in
every case tried against it: a transpose, a slice, a same-rank reshape, a
product, ``cat`` and elementwise ops of a row-block array stay
``rowblock``; a reduction, a flatten, a rank change and an op whose first
operand is untagged read ``replicated``. ``put`` and ``overwrite`` read
the tag with :func:`untag`, which also unwraps the tensor, so no routine,
backend or kernel ever sees the subclass. A plain tensor or a host array
reads ``replicated``, as a fresh JAX array carries no distributed
sharding.
"""
from __future__ import annotations

import torch

from repro_torch.core.handles import REPLICATED


class LayoutTensor(torch.Tensor):
    """A tensor handed out by the engine, tagged with its store's layout
    (``engine_layout``; torch's own ``layout`` is the memory layout)."""

    engine_layout: str = REPLICATED

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs or {})
        with torch._C.DisableTorchFunctionSubclass():
            return _retag(out, _first_tensor(args))


def tag(array: torch.Tensor, layout: str) -> LayoutTensor:
    """``array`` as a :class:`LayoutTensor` tagged ``layout`` (no copy)."""
    out = array.as_subclass(LayoutTensor)
    out.engine_layout = layout
    return out


def untag(array) -> tuple:
    """(the plain tensor or host array, its layout tag): a
    :class:`LayoutTensor`'s own tag, ``replicated`` for anything else."""
    if isinstance(array, LayoutTensor):
        return array.as_subclass(torch.Tensor), array.engine_layout
    return array, REPLICATED


def _first_tensor(args):
    """The op's first argument, or the first tensor of a first-argument
    list; None when that is not a tensor."""
    first = args[0] if args else None
    if isinstance(first, (list, tuple)):
        first = next((t for t in first if isinstance(t, torch.Tensor)), None)
    return first if isinstance(first, torch.Tensor) else None


def _retag(out, first):
    """The tensors of ``out`` tagged with ``first``'s layout where
    ``first`` is tagged and they have its rank, plain otherwise."""
    if isinstance(out, (list, tuple)):
        # a list, a tuple or one of torch's return types (struct sequences)
        return type(out)([_retag(o, first) for o in out])
    if not isinstance(out, LayoutTensor):
        return out
    if not isinstance(first, LayoutTensor) or out.dim() != first.dim():
        return out.as_subclass(torch.Tensor)
    out.engine_layout = first.engine_layout
    return out
