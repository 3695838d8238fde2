"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), as the JAX
package's ``nn/mla.py`` computes it.

KV is compressed to a rank-``kv_lora_rank`` latent c_kv plus a single
shared RoPE key head; the decode cache holds only (c_kv, k_rope). Decode
uses the *absorbed* formulation: W_uk is absorbed into the query and W_uv
into the attention output, so each decode step works on the latent cache
without re-expanding K/V. A full forward or a prefill uses the expanded
formulation (K/V materialised per head) through the plain
:func:`~repro_torch.nn.attention.multihead_attention`: its q/k head dim
(nope + rope, 192 at published widths) and v head dim (128) differ, which
the swa kernel does not take.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.nn.attention import NEG_INF, multihead_attention
from repro_torch.nn.core import fan_in
from repro_torch.nn.linear import Weight
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rope import apply_rope


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor     # (B, T, R)   latent
    k_rope: torch.Tensor   # (B, T, Dr)  shared rope key head


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        self.cfg = cfg

        def w(shape):
            return Weight(fan_in(shape, generator, device))
        # KV path: d -> latent r (+ the shared rope head)
        self.w_dkv = w((d, r))
        self.w_kr = w((d, dr))
        self.kv_norm = RMSNorm(r, cfg.norm_eps, device=device)
        # up-projections latent -> per-head K_nope / V
        self.w_uk = w((r, h, dn))
        self.w_uv = w((r, h, dv))
        self.o = w((h, dv, d))
        if qr:
            self.w_dq = w((d, qr))
            self.q_norm = RMSNorm(qr, cfg.norm_eps, device=device)
            self.w_uq = w((qr, h, dn + dr))
        else:
            self.w_q = w((d, h, dn + dr))

    def _project_q(self, x: torch.Tensor, cd) -> torch.Tensor:
        if self.cfg.q_lora_rank:
            cq = self.q_norm(x @ self.w_dq.w.to(cd))
            return torch.einsum("bsr,rhk->bshk", cq, self.w_uq.w.to(cd))
        return torch.einsum("bsd,dhk->bshk", x, self.w_q.w.to(cd))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[MLACache] = None,
                cache_index: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (out, new_cache). A full forward or a prefill
        (``cache_index`` None; a given ``cache`` is filled from position
        0), or one decode step (S == 1 and ``cache_index`` the number of
        tokens already cached; the cache is updated in place)."""
        cfg = self.cfg
        cd = compute_dtype
        if x.device.type == "cpu":
            settle_cpu_vector_math()
        b, s, _ = x.shape
        h = cfg.num_heads
        dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
        scale = (dn + dr) ** -0.5
        x = x.to(cd)

        q = self._project_q(x, cd)                           # (B,S,H,dn+dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        c_kv = self.kv_norm(x @ self.w_dkv.w.to(cd))
        k_rope = apply_rope((x @ self.w_kr.w.to(cd))[:, :, None, :],
                            positions, cfg.rope_theta)[:, :, 0]

        new_cache = None
        if cache is not None and cache_index is not None and s == 1:
            # --- absorbed decode over the latent cache ---
            cache.c_kv[:, cache_index] = c_kv[:, 0].to(cache.c_kv.dtype)
            cache.k_rope[:, cache_index] = k_rope[:, 0].to(
                cache.k_rope.dtype)
            new_cache = cache
            ckv, kr = cache.c_kv.to(cd), cache.k_rope.to(cd)
            t = ckv.shape[1]
            # W_uk absorbed into the query: q_c (B, 1, H, R)
            q_c = torch.einsum("bshn,rhn->bshr", q_nope, self.w_uk.w.to(cd))
            scores = (torch.einsum("bshr,btr->bhst", q_c, ckv)
                      + torch.einsum("bshk,btk->bhst", q_rope, kr)
                      ).float() * scale
            valid = torch.arange(t, device=x.device) <= cache_index
            scores = torch.where(valid, scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(cd)
            ctx = torch.einsum("bhst,btr->bshr", probs, ckv)
            out = torch.einsum("bshr,rhv->bshv", ctx, self.w_uv.w.to(cd))
        else:
            # --- expanded full forward / prefill ---
            k_nope = torch.einsum("btr,rhn->bthn", c_kv, self.w_uk.w.to(cd))
            v = torch.einsum("btr,rhv->bthv", c_kv, self.w_uv.w.to(cd))
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                          dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            out = multihead_attention(q_full, k, v, positions, positions,
                                      softcap=cfg.logit_softcap)
            if cache is not None:
                ckv = torch.zeros_like(cache.c_kv)
                kr = torch.zeros_like(cache.k_rope)
                ckv[:, :s] = c_kv
                kr[:, :s] = k_rope
                new_cache = MLACache(c_kv=ckv, k_rope=kr)

        out = torch.einsum("bshv,hvd->bsd", out.to(cd), self.o.w.to(cd))
        return out, new_cache
