"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin hybrid: RG-LRU recurrent
blocks + local (sliding-window) attention in a 2:1 pattern.

38 layers, d_model=4096, 16 heads (MQA kv=1, head_dim 256), d_ff=12288,
vocab 256000, window 2048, lru_width 4096.
"""
import dataclasses

from repro_torch.common.config import BlockKind, ModelConfig

ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        block_pattern=(BlockKind.RECURRENT, BlockKind.RECURRENT,
                       BlockKind.LOCAL_ATTENTION),
        sliding_window=2048,
        lru_width=4096,
        conv1d_width=4,
        act="gelu_tanh",
        logit_softcap=0.0,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=3,          # one full (rec, rec, local) cycle
        d_model=128,
        num_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        lru_width=128,
    )
