"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5-architecture dense
decoder (full MHA).

32 layers, d_model=4096, 32 heads (kv=32), d_ff=13440, vocab 92416.
"""
import dataclasses

from repro_torch.common.config import ModelConfig

ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92_416,
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512)
