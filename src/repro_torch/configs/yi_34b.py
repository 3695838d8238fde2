"""Yi-34B [arXiv:2403.04652] — llama-architecture dense decoder with GQA.

60 layers, d_model=7168, 56 heads (GQA kv=8, head_dim 128), d_ff=20480,
vocab 64000.
"""
import dataclasses

from repro_torch.common.config import ModelConfig

ID = "yi-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64_000,
        rope_theta=5_000_000.0,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512)
