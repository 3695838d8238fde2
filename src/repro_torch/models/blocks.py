"""Per-layer blocks, dispatched on BlockKind: one decoder layer is a
temporal mixer (attention / local attention / MLA / RG-LRU) and an FFN
(dense MLP or MoE), with pre-norms and residuals. RWKV is special-cased,
as in the JAX package: its layer owns both residual branches
(:class:`RWKVBlock`, whose parameters sit at the layer's top level).

Every block returns ``(x, new_cache, aux)``: aux is the MoE FFN's router
loss, None for a dense FFN. Cross-attention (encoder-decoder) and a
prefix-LM prefix raise ``NotImplementedError``: they come with ROADMAP
A11c-4 and A11c-5.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import BlockKind, ModelConfig
from repro_torch.nn.attention import Attention, KVCache
from repro_torch.nn.mla import MLA, MLACache
from repro_torch.nn.mlp import MLP
from repro_torch.nn.moe import MoE
from repro_torch.nn.norms import norm
from repro_torch.nn.rglru import RGLRU, RGLRUCache
from repro_torch.nn.rwkv import RWKV, RWKVCache


def check_buildable(cfg: ModelConfig) -> None:
    """Raise unless the port builds ``cfg``: every block kind it does;
    an encoder or a prefix it does not yet."""
    for what, present in (("cross-attention (enc-dec)", cfg.is_encdec),
                          ("a prefix-LM (VLM) prefix", cfg.prefix_len > 0)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not in the port yet (ROADMAP "
                "A11c-4, A11c-5)")


def uses_moe(cfg: ModelConfig, layer: int) -> bool:
    """Whether layer ``layer`` takes the MoE FFN: with a MoE config and a
    one-kind pattern, every layer after the first ``first_dense_layers``
    (the JAX package's dense-then-MoE segments); otherwise none."""
    return cfg.moe is not None and len(cfg.block_pattern) == 1 \
        and layer >= cfg.moe.first_dense_layers


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: BlockKind, *,
                 generator: torch.Generator, device, use_moe: bool = False):
        super().__init__()
        if kind == BlockKind.RWKV:
            raise ValueError("an RWKV layer owns both residual branches: "
                             "build it as an RWKVBlock (make_block)")
        self.kind = kind
        self.cfg = cfg
        self.norm1 = norm(cfg.d_model, cfg.use_layernorm, cfg.norm_eps,
                          device=device)
        if kind == BlockKind.RECURRENT:
            self.temporal = RGLRU(cfg, generator=generator, device=device)
        elif kind == BlockKind.MLA:
            self.temporal = MLA(cfg, generator=generator, device=device)
        else:
            self.temporal = Attention(cfg, generator=generator,
                                      device=device)
        self.norm2 = norm(cfg.d_model, cfg.use_layernorm, cfg.norm_eps,
                          device=device)
        self.ffn = MoE(cfg, generator=generator, device=device) if use_moe \
            else MLP(cfg, generator=generator, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, cache_index: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (x, new_cache, aux)."""
        h = self.norm1(x)
        if self.kind == BlockKind.RECURRENT:
            y, new_cache = self.temporal(h, cache=cache,
                                         compute_dtype=compute_dtype)
        elif self.kind == BlockKind.MLA:
            y, new_cache = self.temporal(
                h, positions, cache=cache, cache_index=cache_index,
                compute_dtype=compute_dtype)
        else:
            window = self.cfg.sliding_window \
                if self.kind == BlockKind.LOCAL_ATTENTION else 0
            y, new_cache = self.temporal(
                h, positions, window=window, cache=cache,
                cache_index=cache_index, compute_dtype=compute_dtype)
        x = x + y.to(x.dtype)
        aux = None
        if isinstance(self.ffn, MoE):
            y2, aux = self.ffn(self.norm2(x), compute_dtype)
        else:
            y2 = self.ffn(self.norm2(x), compute_dtype)
        return x + y2.to(x.dtype), new_cache, aux


class RWKVBlock(RWKV):
    """An RWKV-6 layer as a block: the layer's call, with the block's
    arguments and its (x, new_cache, aux) return (aux always None)."""

    kind = BlockKind.RWKV

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                cache=None, cache_index: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        x, new_cache = super().forward(x, cache=cache,
                                       compute_dtype=compute_dtype)
        return x, new_cache, None


def make_block(cfg: ModelConfig, kind: BlockKind, *,
               generator: torch.Generator, device,
               use_moe: bool = False) -> nn.Module:
    """The layer of ``kind``: an :class:`RWKVBlock`, or a :class:`Block`
    (with the MoE FFN when ``use_moe``)."""
    if kind == BlockKind.RWKV:
        return RWKVBlock(cfg, generator=generator, device=device)
    return Block(cfg, kind, generator=generator, device=device,
                 use_moe=use_moe)


def init_block_cache(cfg: ModelConfig, kind: BlockKind, batch: int,
                     seq_len: int, dtype: torch.dtype, device):
    """Zero-filled cache of one block of ``kind``: K/V (a
    ring of ``min(window, seq_len)`` slots for local attention) and MLA's
    latent and rope key in ``dtype``; the recurrent states, the conv tail
    and RWKV's shifted tokens in fp32."""
    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)
    if kind == BlockKind.RECURRENT:
        w = cfg.lru_width or cfg.d_model
        return RGLRUCache(h=zeros(batch, w),
                          conv=zeros(batch, cfg.conv1d_width - 1, w))
    if kind == BlockKind.RWKV:
        dh = cfg.rwkv_head_dim
        return RWKVCache(state=zeros(batch, cfg.d_model // dh, dh, dh),
                         last=zeros(batch, cfg.d_model),
                         last_cm=zeros(batch, cfg.d_model))
    if kind == BlockKind.MLA:
        return MLACache(c_kv=zeros(batch, seq_len, cfg.kv_lora_rank,
                                   dt=dtype),
                        k_rope=zeros(batch, seq_len, cfg.rope_head_dim,
                                     dt=dtype))
    t = seq_len if kind == BlockKind.ATTENTION else \
        min(cfg.sliding_window, seq_len)
    shape = (batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=zeros(*shape, dt=dtype), v=zeros(*shape, dt=dtype))
