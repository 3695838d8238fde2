"""The layout tag that follows a tensor out of the engine and back in.

The JAX engine reads a store's layout from its array's sharding
(``layout_of``), and an array computed from an engine array keeps that
sharding. A torch tensor carries no sharding, so the port's public
``AlchemistEngine.get`` hands out a :class:`LayoutTensor`: the store's
tensor itself (a view, no copy) tagged with the store's layout. An op
whose result has the shape and strides of its tagged operands, and whose
tagged operands agree, tags the result the same (an elementwise op, a
copy, an in-place update); any other result is a plain tensor. ``put``
and ``overwrite`` read the tag with :func:`untag`, which also unwraps the
tensor, so no routine, backend or kernel ever sees the subclass. A plain tensor or a host array reads ``replicated``, as a fresh
JAX array carries no distributed sharding.

Results the tag does not follow yet (ROADMAP C3'), where the JAX engine
derives a layout from the sharding XLA propagates to the result: a
transpose, a slice or a reshape of a row-block array (``rowblock`` there,
``replicated`` here), and any other op whose result's shape or strides
differ from its tagged operands'. A square product keeps its operands'
tag.
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
            tagged = [t for t in _leaves((args, kwargs))
                      if isinstance(t, LayoutTensor)]
            return _retag(out, tagged)


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


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _leaves(item)
    else:
        yield tree


def _retag(out, tagged: list):
    """The tensors of ``out`` tagged where the tagged operands of their
    shape and strides agree on one layout, plain otherwise (strides too,
    so a square transpose loses the tag)."""
    if isinstance(out, (list, tuple)):
        # a list, a tuple or one of torch's return types (struct sequences)
        return type(out)([_retag(o, tagged) for o in out])
    if not isinstance(out, LayoutTensor):
        return out
    layouts = {t.engine_layout for t in tagged
               if t.shape == out.shape and t.stride() == out.stride()}
    if len(layouts) != 1:
        return out.as_subclass(torch.Tensor)
    out.engine_layout = layouts.pop()
    return out
