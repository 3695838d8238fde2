"""Roofline accounting of the port on one H100: the JAX package's analytic
arithmetic (``launch/roofline.py`` there), which is framework-neutral,
combined with the card's constants (``common.config.H100``) in place of
the TPU's ``V5E``.

  * ``model_flops``: analytic step FLOPs (6ND-style, per architecture),
    the compute term's input;
  * ``param_count`` / ``active_param_count`` / ``cache_bytes`` /
    ``analytic_decode_bytes_per_chip``: as the JAX package counts them;
  * ``build_report``: the compute and memory terms of one step on the
    card; one device, so the collective term is 0.

The JAX package's ``collective_bytes_by_kind`` parses XLA's HLO for the
bytes each collective moves between chips. The port compiles no HLO and
runs on one card, so it has no counterpart.

One difference from the JAX package, a fault there (ROADMAP C13): its
``model_flops`` counts Whisper's encoder attention at a context of
``encoder_seq / 2``, as if the encoder were causal. The encoder is
bidirectional (the port runs it at prefix = window = S), so every frame
attends to all ``encoder_seq`` frames: its score and context FLOPs are
2 * 2 * encoder_seq * d_enc a frame, as counted here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.config import (
    H100,
    BlockKind,
    HardwareSpec,
    ModelConfig,
    ShapeConfig,
)


# ---------------------------------------------------------------------------
# Analytic FLOPs (per whole step)
# ---------------------------------------------------------------------------
def _layer_flops_per_token(cfg: ModelConfig, kind: BlockKind, use_moe: bool,
                           ctx: float) -> float:
    """Forward FLOPs per token for one layer; ctx = average attended length."""
    d = cfg.d_model
    h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f = 0.0
    if kind in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION):
        f += 2 * d * (h * dh + 2 * k * dh)           # qkv proj
        f += 2 * 2 * ctx * h * dh                    # scores + context
        f += 2 * h * dh * d                          # output proj
    elif kind == BlockKind.MLA:
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        if qr:
            f += 2 * (d * qr + qr * h * (dn + dr))
        else:
            f += 2 * d * h * (dn + dr)
        f += 2 * d * (r + dr)                        # latent + rope key
        f += 2 * r * h * (dn + dv)                   # up-projections
        f += 2 * 2 * ctx * h * (dn + dr)             # scores(+rope) + context
        f += 2 * h * dv * d                          # output proj
    elif kind == BlockKind.RECURRENT:
        w = cfg.lru_width or d
        f += 2 * d * w * 2                           # in / gate proj
        f += 2 * w * w * 2                           # recurrence gates
        f += 2 * cfg.conv1d_width * w                # depthwise conv
        f += 10 * w                                  # elementwise recurrence
        f += 2 * w * d                               # out proj
    elif kind == BlockKind.RWKV:
        dh_r = cfg.rwkv_head_dim
        f += 2 * d * d * 5                           # r,k,v,g,out projections
        f += 4 * 2 * d * dh_r                        # wkv state update+readout
        f += 2 * d * cfg.d_ff * 2 + 2 * d * d        # channel mix (+gate)
    # FFN
    if use_moe and cfg.moe is not None:
        m = cfg.moe
        active = m.top_k + m.num_shared_experts
        f += 2 * d * m.expert_ff * 3 * active
        f += 2 * d * m.num_experts                   # router
    elif kind != BlockKind.RWKV:                     # rwkv owns its ffn
        f += 2 * d * cfg.d_ff * (3 if cfg.glu else 2)
    return f


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic step FLOPs (forward; x3 for training fwd+bwd)."""
    s = shape.seq_len
    b = shape.global_batch
    decode = shape.is_decode
    n_tokens = b * (1 if decode else (s - (cfg.prefix_len or 0)
                                      if cfg.prefix_len else s))
    if cfg.prefix_len and not decode:
        n_tokens = b * s                            # prefix tokens also flow

    kinds = cfg.block_kinds()
    nd = cfg.moe.first_dense_layers if cfg.moe else 0
    total = 0.0
    for i, kind in enumerate(kinds):
        if decode:
            ctx = min(cfg.sliding_window, s) if kind == BlockKind.LOCAL_ATTENTION else s
        else:
            ctx = min(cfg.sliding_window, s / 2) if kind == BlockKind.LOCAL_ATTENTION else s / 2
        use_moe = cfg.moe is not None and i >= nd
        total += n_tokens * _layer_flops_per_token(cfg, kind, use_moe, ctx)
    # unembed (+embed gather is negligible)
    total += 2 * n_tokens * cfg.d_model * cfg.vocab_size
    # whisper encoder: bidirectional, every frame attends to every frame
    # (C13: the JAX package counts encoder_seq / 2)
    if cfg.is_encdec:
        enc_d = cfg.encoder_d_model or cfg.d_model
        enc_tokens = b * cfg.encoder_seq
        per = (2 * enc_d * 4 * enc_d                 # qkv+o (h*dh = d)
               + 2 * 2 * cfg.encoder_seq * enc_d
               + 2 * enc_d * cfg.d_ff * (3 if cfg.glu else 2))
        total += enc_tokens * per * cfg.encoder_layers
    if shape.mode == "train":
        total *= 3.0                                 # fwd + bwd
    return total


def cache_bytes(cfg: ModelConfig, shape: ShapeConfig,
                dtype_bytes: int = 2) -> float:
    """Total decode-state bytes (all layers, global batch)."""
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    for kind in cfg.block_kinds():
        if kind == BlockKind.ATTENTION:
            total += b * s * cfg.num_kv_heads * cfg.resolved_head_dim \
                * 2 * dtype_bytes
        elif kind == BlockKind.LOCAL_ATTENTION:
            t = min(cfg.sliding_window, s)
            total += b * t * cfg.num_kv_heads * cfg.resolved_head_dim \
                * 2 * dtype_bytes
        elif kind == BlockKind.MLA:
            total += b * s * (cfg.kv_lora_rank + cfg.rope_head_dim) \
                * dtype_bytes
        elif kind == BlockKind.RECURRENT:
            w = cfg.lru_width or cfg.d_model
            total += b * w * 4 * (1 + cfg.conv1d_width - 1)
        elif kind == BlockKind.RWKV:
            h = cfg.d_model // cfg.rwkv_head_dim
            total += b * (h * cfg.rwkv_head_dim ** 2 + 2 * cfg.d_model) * 4
    if cfg.is_encdec:
        enc_d = cfg.encoder_d_model or cfg.d_model
        total += cfg.num_layers * b * cfg.encoder_seq * enc_d * 2 \
            * dtype_bytes
    return total


def analytic_decode_bytes_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                                   chips: int = 1,
                                   param_bytes: int = 2) -> float:
    """Device-memory traffic of one decode step: read every parameter
    once (bf16) + read the whole cache + write the updated cache slot
    (one token, counted as cache/S). On one card ``chips`` is 1."""
    pc = param_count(cfg) * param_bytes
    cb = cache_bytes(cfg, shape)
    return (pc + cb * (1.0 + 1.0 / max(shape.seq_len, 1))) / chips


def param_count(cfg: ModelConfig) -> float:
    """Approximate parameter count (for 6ND cross-checks)."""
    kinds = cfg.block_kinds()
    nd = cfg.moe.first_dense_layers if cfg.moe else 0
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for i, kind in enumerate(kinds):
        use_moe = cfg.moe is not None and i >= nd
        h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        if kind in (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION):
            total += d * dh * (h + 2 * k) + h * dh * d
        elif kind == BlockKind.MLA:
            r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
            dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
            total += (d * qr + qr * h * (dn + dr)) if qr else d * h * (dn + dr)
            total += d * (r + dr) + r * h * (dn + dv) + h * dv * d
        elif kind == BlockKind.RECURRENT:
            w = cfg.lru_width or d
            total += 2 * d * w + 2 * w * w + w * d
        elif kind == BlockKind.RWKV:
            total += 5 * d * d + 2 * d * cfg.d_ff + d * d
        if cfg.moe is not None and use_moe:
            m = cfg.moe
            total += m.num_experts * 3 * d * m.expert_ff
            total += m.num_shared_experts * 3 * d * m.expert_ff + d * m.num_experts
        elif kind != BlockKind.RWKV:
            total += d * cfg.d_ff * (3 if cfg.glu else 2)
    if cfg.is_encdec:
        enc_d = cfg.encoder_d_model or cfg.d_model
        total += cfg.encoder_layers * (4 * enc_d * enc_d
                                       + enc_d * cfg.d_ff * (3 if cfg.glu else 2))
        # cross attention in every decoder layer
        total += cfg.num_layers * 4 * d * d
    return float(total)


def active_param_count(cfg: ModelConfig) -> float:
    """Params touched per token (MoE: routed top-k + shared only)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    routed_all = (cfg.num_layers - m.first_dense_layers) \
        * m.num_experts * 3 * cfg.d_model * m.expert_ff
    routed_active = routed_all * (m.top_k / m.num_experts)
    return param_count(cfg) - routed_all + routed_active


@dataclasses.dataclass
class RooflineReport:
    """One step's least time on the card: the compute term (analytic
    model FLOPs over the bf16 peak) and the memory term (the step's
    device bytes over the HBM rate); the larger dominates. No collective
    term: one device."""
    arch: str
    shape: str
    card: str
    chips: int
    model_flops: float
    bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str

    def to_dict(self):
        return dataclasses.asdict(self)


def build_report(arch: str, shape_cfg: ShapeConfig, cfg: ModelConfig,
                 bytes_per_device: float,
                 hw: HardwareSpec = H100) -> RooflineReport:
    """The roofline of one step of ``cfg`` at ``shape_cfg`` on one card:
    ``bytes_per_device`` is what the step must move through device
    memory (the dry run's reckoning, where the JAX package reads XLA's
    ``bytes accessed``)."""
    mf = model_flops(cfg, shape_cfg)
    compute_s = mf / hw.peak_flops
    memory_s = float(bytes_per_device) / hw.hbm_bw
    dominant = "compute" if compute_s >= memory_s else "memory"
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, card=hw.card, chips=1,
        model_flops=mf, bytes_per_device=float(bytes_per_device),
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        dominant=dominant)
