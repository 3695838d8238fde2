"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free SSM with
data-dependent decay.

24 layers, d_model=2048, d_ff=7168 (channel-mix), vocab 65536, head_dim 64.
"""
import dataclasses

from repro_torch.common.config import BlockKind, ModelConfig

ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=24,
        d_model=2048,
        num_heads=32,            # d_model / rwkv_head_dim
        num_kv_heads=32,
        d_ff=7168,
        vocab_size=65_536,
        block_pattern=(BlockKind.RWKV,),
        rwkv_head_dim=64,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, rwkv_head_dim=32)
