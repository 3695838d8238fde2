"""Attention: GQA/MQA, causal / sliding-window / prefix-LM / cross, with a
KV cache that is a ring buffer of ``window`` slots for sliding-window
layers, so long-context decode stays O(window) per layer, and a cross
cache of the encoder's K/V written once at prefill.

Routes, by the function computed (never by whether a kernel built):
  * a causal self-attention full forward or prefill with no softcap runs
    ``kernels.swa_attention`` (the CUDA kernel on the card): windowed
    layers with their window, global layers with window = S, which is
    causal attention, a prefix-LM's layers (PaliGemma) with window = S and
    ``prefix = prefix_len``, its first positions attending to each other
    in both directions;
  * the encoder's non-causal self-attention (Whisper) runs
    ``swa_attention`` with window = prefix = S: with kv_pos = q_pos a
    prefix of S is bidirectional attention.
    With ``kv_pos = q_pos`` the kernel computes exactly the masked softmax
    of :func:`multihead_attention`, and never builds the (S, S) scores.
    Under autograd (training) that is the kernel's
    ``torch.autograd.Function``, whose backward is the swa backward
    kernel on the card, the prefix included; its gradients arrive in the
    layout of the (B, S, H, D) views passed in, so nothing is copied for
    them;
  * every other case — cross-attention (its keys are the encoder's
    frames, not the queries), decode over the cache or the cross cache, a
    softcap — runs the plain masked :func:`multihead_attention`, as the
    JAX package computes it in XLA (autograd differentiates it there). So
    does MLA's expanded prefill (``nn/mla.py``), whose q/k and v head dims
    differ.

Rotary embeddings apply to self-attention only: cross-attention and the
encoder (``use_rope=False``) take none.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.kernels.swa import swa_attention
from repro_torch.nn.core import fan_in, ones, parameter
from repro_torch.nn.linear import Weight
from repro_torch.nn.rope import apply_rope

NEG_INF = -2.0e38


@dataclasses.dataclass
class KVCache:
    """Pre-allocated cache. For sliding-window blocks, ``k``/``v`` hold only
    the last ``window`` positions (ring buffer: slot = position % window);
    otherwise full length."""

    k: torch.Tensor   # (B, T, K, Dh)
    v: torch.Tensor   # (B, T, K, Dh)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """(B, 1, 1, s, t) boolean mask (True = attend), as the JAX package's
    ``_mask``: causal, keys and queries below ``prefix_len`` also seeing
    each other (a prefix-LM's bidirectional prefix), limited to
    (q - window, q] when ``window`` (the prefix clause OR-ed before the
    window clause is AND-ed); every key when not ``causal``; kv_pos -1 =
    empty slot."""
    q = q_pos[:, :, None]
    kv = kv_pos[:, None, :]
    if causal:
        ok = kv <= q
        if prefix_len:
            ok = ok | ((kv < prefix_len) & (q < prefix_len))
        if window:
            ok = ok & (kv > q - window)
    else:
        ok = torch.ones_like(kv <= q)
    return (ok & (kv >= 0))[:, None, None, :, :]


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        prefix_len: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """The plain masked attention (:func:`_mask`). q: (B, S, H, Dh); k, v:
    (B, T, K, Dh); q_pos (B, S), kv_pos (B, T). Scores in fp32 from the
    operands' values (the JAX package's bf16 operands with fp32
    accumulation); returns (B, S, H, Dv) in v's dtype. The (S, T) scores are materialised: the
    JAX package's query chunking only bounds memory."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * dh ** -0.5
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = _mask(q_pos, kv_pos, causal=causal, window=window,
                 prefix_len=prefix_len)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


class Attention(nn.Module):
    """``kv_d_model`` (cross-attention: the encoder's width) sizes the k
    and v projections' input, ``d_model`` by default, as the JAX
    package's ``attention_spec(..., kv_d_model=)``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device, kv_d_model: int = 0):
        super().__init__()
        d, h, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        dh = cfg.resolved_head_dim
        kv_d = kv_d_model or d
        self.cfg = cfg
        self.q = Weight(fan_in((d, h, dh), generator, device))
        self.k = Weight(fan_in((kv_d, k, dh), generator, device))
        self.v = Weight(fan_in((kv_d, k, dh), generator, device))
        self.o = Weight(fan_in((h, dh, d), generator, device))
        if cfg.qk_norm:
            self.q_norm = _Scale(dh, device)
            self.k_norm = _Scale(dh, device)

    def _project(self, x: torch.Tensor, w: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
        """(B, S, d) @ (d, heads, Dh) -> contiguous (B, S, heads, Dh)."""
        b, s, d = x.shape
        w = w.to(compute_dtype)
        return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0, prefix_len: int = 0,
                kv_x: Optional[torch.Tensor] = None, cross: bool = False,
                use_rope: bool = True, cache: Optional[KVCache] = None,
                cache_index: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (out, new_cache). ``kv_x`` (or ``cross``) makes it
        cross-attention: keys and values from ``kv_x`` (B, T, kv_d_model),
        every key visible, no rope. Modes:
          * full forward / prefill (``cache_index`` None): ``positions``
            must be ``arange(S)`` in every row, as ``DecoderLM.forward``
            gives them — the kernel's band and prefix mask and the ring
            layout of the written cache are taken from it without reading
            it back from the device; a given ``cache`` is filled from
            scratch (for cross-attention: the (B, T, K, Dh) K/V of
            ``kv_x``);
          * decode: S == 1 and ``cache_index`` is the number of tokens
            already cached. A self-attention cache is updated in place
            (one slot per step, no copy of the whole cache) and returned;
            cross-attention reads the cross cache and returns it as it
            is.
        """
        cfg = self.cfg
        if x.device.type == "cpu":
            settle_cpu_vector_math()
        b, s, _ = x.shape
        is_cross = cross or kv_x is not None
        decode = cache is not None and cache_index is not None and s == 1
        x = x.to(compute_dtype)
        q = self._project(x, self.q.w, compute_dtype)
        if cfg.qk_norm:
            q = _rmsnorm(q, self.q_norm.scale)
        if is_cross and decode:
            # --- cross-attention decode: the encoder's K/V from the cache
            t = cache.k.shape[1]
            kv_pos = torch.arange(t, device=x.device).expand(b, t)
            out = multihead_attention(
                q, cache.k.to(compute_dtype), cache.v.to(compute_dtype),
                positions, kv_pos, causal=False, softcap=cfg.logit_softcap)
            return self._out(out, b, s, compute_dtype), cache
        src = x if kv_x is None else kv_x.to(compute_dtype)
        k = self._project(src, self.k.w, compute_dtype)
        v = self._project(src, self.v.w, compute_dtype)
        if cfg.qk_norm:
            k = _rmsnorm(k, self.k_norm.scale)
        if use_rope and not is_cross:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

        new_cache = None
        if is_cross:
            # --- cross-attention full forward / prefill: every frame
            t = k.shape[1]
            kv_pos = torch.arange(t, device=x.device).expand(b, t)
            out = multihead_attention(q, k, v, positions, kv_pos,
                                      causal=False,
                                      softcap=cfg.logit_softcap)
            if cache is not None:
                new_cache = _prefill_cache(cache, k, v)
        elif decode:
            # --- decode: write this token's K/V, attend over the cache ---
            t = cache.k.shape[1]
            ring = bool(window) and t <= window
            slot = cache_index % t if ring else cache_index
            cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
            cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
            new_cache = cache
            slots = torch.arange(t, device=x.device)
            if ring:
                # slot i holds the largest position p <= cache_index with
                # p % t == i, or nothing yet
                kv_positions = cache_index - (slot - slots) % t
                kv_positions = torch.where(kv_positions >= 0,
                                           kv_positions, -1)
            else:
                kv_positions = torch.where(slots <= cache_index, slots, -1)
            kv_pos = kv_positions[None, :].expand(b, t)
            out = multihead_attention(
                q, cache.k.to(compute_dtype), cache.v.to(compute_dtype),
                positions, kv_pos, causal=causal, window=window,
                prefix_len=prefix_len, softcap=cfg.logit_softcap)
        else:
            # --- full forward / prefill ---
            if cfg.logit_softcap:
                out = multihead_attention(q, k, v, positions, positions,
                                          causal=causal, window=window,
                                          prefix_len=prefix_len,
                                          softcap=cfg.logit_softcap)
            else:
                # a prefix past S covers all S positions; not causal, every
                # position is in the prefix and the window
                band, prefix = (window or s, min(prefix_len, s)) if causal \
                    else (s, s)
                out = swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window=band,
                                    prefix=prefix).transpose(1, 2)
            if cache is not None:
                new_cache = _prefill_cache(cache, k, v)
        return self._out(out, b, s, compute_dtype), new_cache

    def _out(self, out: torch.Tensor, b: int, s: int,
             compute_dtype: torch.dtype) -> torch.Tensor:
        """The output projection of (B, S, H, Dv) heads to (B, S, d)."""
        out = out.reshape(b, s, -1).to(compute_dtype)
        w_o = self.o.w.to(compute_dtype)
        return out @ w_o.reshape(-1, w_o.shape[-1])


class _Scale(nn.Module):
    """The JAX package's ``{"scale": ...}`` subtree of a qk-norm."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = parameter(ones((dim,), device))


def _prefill_cache(cache: KVCache, k: torch.Tensor,
                   v: torch.Tensor) -> KVCache:
    """The cache after a prefill of positions 0..S-1: a ring of T < S slots
    keeps the last T positions at slot = position % T; a longer cache
    takes all S positions from slot 0, zeros after (a cross cache: the
    encoder's T frames, all of them)."""
    t = cache.k.shape[1]
    s = k.shape[1]
    if t < s:
        roll = (s - t) % t       # the first kept position, modulo T
        return KVCache(
            k=torch.roll(k[:, -t:], shifts=roll, dims=1).to(cache.k.dtype),
            v=torch.roll(v[:, -t:], shifts=roll, dims=1).to(cache.v.dtype))
    ck = torch.zeros_like(cache.k)
    cv = torch.zeros_like(cache.v)
    ck[:, :s] = k
    cv[:, :s] = v
    return KVCache(k=ck, v=cv)
