"""Per-layer blocks, dispatched on BlockKind: one decoder layer is a
temporal mixer (attention / local attention / MLA / RG-LRU) and an FFN
(dense MLP or MoE), with pre-norms and residuals. RWKV is special-cased,
as in the JAX package: its layer owns both residual branches
(:class:`RWKVBlock`, whose parameters sit at the layer's top level).

Every block returns ``(x, new_cache, new_cross_cache, aux)``, as the JAX
package's ``block_apply``: aux is the MoE FFN's router loss, None for a
dense FFN. A decoder block of an encoder-decoder also holds
cross-attention (``norm_x``, ``cross``) over the encoder's output, whose
K/V it writes to its cross cache at prefill and reads from it in decode;
a global attention block takes the prefix-LM's ``prefix_len``. The
encoder's layers are :class:`EncoderBlock`.
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


def uses_moe(cfg: ModelConfig, layer: int) -> bool:
    """Whether layer ``layer`` takes the MoE FFN: with a MoE config and a
    one-kind pattern, every layer after the first ``first_dense_layers``
    (the JAX package's dense-then-MoE segments); otherwise none."""
    return cfg.moe is not None and len(cfg.block_pattern) == 1 \
        and layer >= cfg.moe.first_dense_layers


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: BlockKind, *,
                 generator: torch.Generator, device, use_moe: bool = False,
                 cross_attention: bool = False):
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
        self.cross = None
        if cross_attention:
            self.norm_x = norm(cfg.d_model, cfg.use_layernorm, cfg.norm_eps,
                               device=device)
            self.cross = Attention(cfg, generator=generator, device=device,
                                   kv_d_model=cfg.encoder_d_model)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, cache_index: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_cache: Optional[KVCache] = None, prefix_len: int = 0,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (x, new_cache, new_cross_cache, aux). ``enc_out`` (a
        full forward or prefill) or ``cross_cache`` (decode) feeds the
        cross-attention; ``prefix_len`` reaches global attention only, as
        in the JAX package."""
        h = self.norm1(x)
        if self.kind == BlockKind.RECURRENT:
            y, new_cache = self.temporal(h, cache=cache,
                                         compute_dtype=compute_dtype)
        elif self.kind == BlockKind.MLA:
            y, new_cache = self.temporal(
                h, positions, cache=cache, cache_index=cache_index,
                compute_dtype=compute_dtype)
        elif self.kind == BlockKind.LOCAL_ATTENTION:
            y, new_cache = self.temporal(
                h, positions, window=self.cfg.sliding_window, cache=cache,
                cache_index=cache_index, compute_dtype=compute_dtype)
        else:
            y, new_cache = self.temporal(
                h, positions, prefix_len=prefix_len, cache=cache,
                cache_index=cache_index, compute_dtype=compute_dtype)
        x = x + y.to(x.dtype)
        new_cross = cross_cache
        if self.cross is not None:
            yx, new_cross = self.cross(
                self.norm_x(x), positions, kv_x=enc_out, cross=True,
                cache=cross_cache, cache_index=cache_index,
                compute_dtype=compute_dtype)
            x = x + yx.to(x.dtype)
        aux = None
        if isinstance(self.ffn, MoE):
            y2, aux = self.ffn(self.norm2(x), compute_dtype)
        else:
            y2 = self.ffn(self.norm2(x), compute_dtype)
        return x + y2.to(x.dtype), new_cache, new_cross, aux


class RWKVBlock(RWKV):
    """An RWKV-6 layer as a block: the layer's call, with the block's
    arguments and its (x, new_cache, new_cross_cache, aux) return (the
    cross cache as given, aux always None)."""

    kind = BlockKind.RWKV

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                cache=None, cache_index: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_cache: Optional[KVCache] = None, prefix_len: int = 0,
                compute_dtype: torch.dtype = torch.bfloat16):
        x, new_cache = super().forward(x, cache=cache,
                                       compute_dtype=compute_dtype)
        return x, new_cache, cross_cache, None


class EncoderBlock(nn.Module):
    """One encoder layer of an encoder-decoder (the JAX package's
    ``EncDecLM`` encoder block): pre-norm bidirectional self-attention
    without rope, then the MLP, with residuals. ``enc_cfg`` is the
    decoder's config at the encoder's width with every head its own kv
    head; parameters ``norm1``, ``self``, ``norm2``, ``ffn`` as the JAX
    package names them."""

    def __init__(self, enc_cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        d = enc_cfg.d_model
        self.norm1 = norm(d, enc_cfg.use_layernorm, enc_cfg.norm_eps,
                          device=device)
        self.self = Attention(enc_cfg, generator=generator, device=device)
        self.norm2 = norm(d, enc_cfg.use_layernorm, enc_cfg.norm_eps,
                          device=device)
        self.ffn = MLP(enc_cfg, generator=generator, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        y, _ = self.self(self.norm1(x), positions, causal=False,
                         use_rope=False, compute_dtype=compute_dtype)
        x = x + y.to(x.dtype)
        return x + self.ffn(self.norm2(x), compute_dtype).to(x.dtype)


def make_block(cfg: ModelConfig, kind: BlockKind, *,
               generator: torch.Generator, device,
               use_moe: bool = False) -> nn.Module:
    """The layer of ``kind``: an :class:`RWKVBlock`, or a :class:`Block`
    (with the MoE FFN when ``use_moe``, and cross-attention in an
    encoder-decoder's decoder)."""
    if kind == BlockKind.RWKV:
        return RWKVBlock(cfg, generator=generator, device=device)
    return Block(cfg, kind, generator=generator, device=device,
                 use_moe=use_moe, cross_attention=cfg.is_encdec)


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
