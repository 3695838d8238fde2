"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b] — dense decoder.

24 layers, d_model=2048, 32 heads (kv=32, i.e. full MHA), d_ff=5632,
vocab 100352. LayerNorm (with bias) per the model card.
"""
import dataclasses

from repro_torch.common.config import ModelConfig

ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        use_layernorm=True,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512)
