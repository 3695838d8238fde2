"""Per-layer blocks, dispatched on BlockKind: one decoder layer is a
temporal mixer (attention / local attention / RG-LRU) and a dense MLP,
with pre-norms and residuals.

The port builds ``RECURRENT``, ``LOCAL_ATTENTION`` and ``ATTENTION``. MLA,
RWKV, MoE and cross-attention raise ``NotImplementedError``: they come
with ROADMAP A11c.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import BlockKind, ModelConfig
from repro_torch.nn.attention import Attention, KVCache
from repro_torch.nn.mlp import MLP
from repro_torch.nn.norms import norm
from repro_torch.nn.rglru import RGLRU, RGLRUCache

BUILT_KINDS = (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION,
               BlockKind.RECURRENT)


def check_buildable(cfg: ModelConfig) -> None:
    """Raise unless the port builds every block of ``cfg``."""
    missing = sorted({k.value for k in cfg.block_kinds()
                      if k not in BUILT_KINDS})
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kind(s) {missing} are not in the port yet "
            "(ROADMAP A11c)")
    for what, present in (("MoE", cfg.moe is not None),
                          ("cross-attention (enc-dec)", cfg.is_encdec),
                          ("a prefix-LM (VLM) prefix", cfg.prefix_len > 0)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not in the port yet (ROADMAP A11c)")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: BlockKind, *,
                 generator: torch.Generator, device):
        super().__init__()
        if kind not in BUILT_KINDS:
            raise NotImplementedError(
                f"block kind {kind.value!r} is not in the port yet "
                "(ROADMAP A11c)")
        self.kind = kind
        self.cfg = cfg
        self.norm1 = norm(cfg.d_model, cfg.use_layernorm, cfg.norm_eps,
                          device=device)
        if kind == BlockKind.RECURRENT:
            self.temporal = RGLRU(cfg, generator=generator, device=device)
        else:
            self.temporal = Attention(cfg, generator=generator,
                                      device=device)
        self.norm2 = norm(cfg.d_model, cfg.use_layernorm, cfg.norm_eps,
                          device=device)
        self.ffn = MLP(cfg, generator=generator, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, cache_index: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (x, new_cache)."""
        h = self.norm1(x)
        if self.kind == BlockKind.RECURRENT:
            y, new_cache = self.temporal(h, cache=cache,
                                         compute_dtype=compute_dtype)
        else:
            window = self.cfg.sliding_window \
                if self.kind == BlockKind.LOCAL_ATTENTION else 0
            y, new_cache = self.temporal(
                h, positions, window=window, cache=cache,
                cache_index=cache_index, compute_dtype=compute_dtype)
        x = x + y.to(x.dtype)
        y2 = self.ffn(self.norm2(x), compute_dtype)
        return x + y2.to(x.dtype), new_cache


def init_block_cache(cfg: ModelConfig, kind: BlockKind, batch: int,
                     seq_len: int, dtype: torch.dtype, device):
    """Zero-filled cache of one block of a kind in ``BUILT_KINDS``: K/V in
    ``dtype`` (a ring of ``min(window, seq_len)`` slots for local
    attention), the recurrent state and conv tail in fp32."""
    if kind == BlockKind.RECURRENT:
        w = cfg.lru_width or cfg.d_model
        return RGLRUCache(
            h=torch.zeros((batch, w), dtype=torch.float32, device=device),
            conv=torch.zeros((batch, cfg.conv1d_width - 1, w),
                             dtype=torch.float32, device=device))
    t = seq_len if kind == BlockKind.ATTENTION else \
        min(cfg.sliding_window, seq_len)
    shape = (batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
