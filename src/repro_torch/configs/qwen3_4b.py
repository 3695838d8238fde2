"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense decoder with QK-norm and GQA.

36 layers, d_model=2560, 32 heads (GQA kv=8, head_dim 128), d_ff=9728,
vocab 151936. A sliding-window variant ("qwen3-4b-sw", window 4096) is
registered for the long_500k shape (see DESIGN.md).
"""
import dataclasses

from repro_torch.common.config import BlockKind, ModelConfig

ID = "qwen3-4b"
ID_SW = "qwen3-4b-sw"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def config_sw() -> ModelConfig:
    return dataclasses.replace(
        config(), name=ID_SW,
        block_pattern=(BlockKind.LOCAL_ATTENTION,),
        sliding_window=4096)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512)


def reduced_sw() -> ModelConfig:
    return dataclasses.replace(
        config_sw(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, sliding_window=16)
