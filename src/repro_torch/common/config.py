"""Configuration dataclasses for models, shapes and training, copied from
the JAX package's ``common/config.py`` so that a configuration reads the
same in both packages. ``MeshConfig`` is left out: the port runs on one
device. ``HardwareSpec`` holds the card's constants for the roofline
(``launch/roofline.py``) in place of the JAX package's TPU ``V5E``."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class BlockKind(str, enum.Enum):
    """Per-layer block type, enabling hybrid stacks (e.g. recurrentgemma)."""

    ATTENTION = "attention"          # full (causal) attention
    LOCAL_ATTENTION = "local_attn"   # sliding-window attention
    RECURRENT = "recurrent"          # RG-LRU block
    RWKV = "rwkv"                    # RWKV6 time-mix + channel-mix
    MLA = "mla"                      # multi-head latent attention (deepseek)


class AttentionKind(str, enum.Enum):
    FULL = "full"
    SLIDING = "sliding"
    PREFIX = "prefix"    # bidirectional over prefix, causal over suffix (VLM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_shared_experts: int
    top_k: int
    expert_ff: int                # d_ff of each routed expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # first_dense_layers: leading layers that use a dense MLP instead of MoE
    # (deepseek-v2 uses 1 dense layer at the bottom).
    first_dense_layers: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    block_pattern: Sequence[BlockKind] = (BlockKind.ATTENTION,)
    # --- attention details ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0                 # >0 for LOCAL_ATTENTION blocks
    attention_kind: AttentionKind = AttentionKind.FULL
    logit_softcap: float = 0.0
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0                   # >0 enables MLA cache compression
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- SSM / recurrent ---
    lru_width: Optional[int] = None         # RG-LRU recurrence width
    conv1d_width: int = 4                   # temporal conv in recurrent block
    rwkv_head_dim: int = 64
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                    # fixed frame count (stub frontend)
    encoder_d_model: int = 0
    # --- VLM (paligemma) ---
    prefix_len: int = 0                     # image-patch prefix length (stub)
    # --- misc ---
    tie_embeddings: bool = False
    act: str = "silu"                       # silu | gelu | gelu_tanh
    glu: bool = True                        # gated MLP (SwiGLU/GeGLU)
    norm_eps: float = 1e-6
    use_layernorm: bool = False             # LayerNorm instead of RMSNorm
    post_attn_norm: bool = False            # extra norms (gemma-style) unused
    dtype: str = "bfloat16"
    # remat policy for the scan body: "full" | "none"
    remat: str = "full"
    # >0: sequence-chunked unembed+xent (never materializes (B,S,V) logits)
    loss_chunk: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_kinds(self) -> list[BlockKind]:
        """Expanded per-layer block kinds (pattern tiled over num_layers)."""
        pat = list(self.block_pattern)
        return [pat[i % len(pat)] for i in range(self.num_layers)]

    def supports_long_context(self) -> bool:
        kinds = set(self.block_kinds())
        quadratic = {BlockKind.ATTENTION, BlockKind.MLA}
        return not (kinds & quadratic)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, mode="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, mode="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, mode="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, mode="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    # GaLore-style offloaded low-rank projection (Alchemist SVD service)
    galore_rank: int = 0
    galore_refresh_every: int = 200


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One card's peaks for the roofline: NVIDIA's data sheet for the H100
    SXM (dense tensor-core rates for bf16 and TF32, the fp32 CUDA-core
    rate, HBM3 bandwidth and capacity), the rates the bounds of
    ``chip_smoke.py``, the launch checks, kernel_bench and ``PERF.md`` use.
    They assume the full power limit; a card set lower runs slower under
    load. One device: no interconnect term."""
    card: str = "NVIDIA H100 80GB HBM3, 700 W"
    peak_flops: float = 989e12       # bf16 FLOP/s, dense tensor cores
    tf32_flops: float = 495e12       # TF32 FLOP/s, dense tensor cores
    fp32_flops: float = 67e12        # fp32 FLOP/s, CUDA cores
    hbm_bw: float = 3.35e12          # bytes/s
    hbm_bytes: float = 80e9          # device memory


H100 = HardwareSpec()
