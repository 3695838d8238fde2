"""Whisper-medium [arXiv:2212.04356] — encoder-decoder audio model.
The mel-spectrogram + conv frontend is a STUB: input_specs supplies
precomputed frame embeddings (B, 1500, 1024).

24+24 layers, d_model=1024, 16 heads (MHA), d_ff=4096, vocab 51865,
LayerNorm, plain GELU MLP (no GLU).
"""
import dataclasses

from repro_torch.common.config import ModelConfig

ID = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51_865,
        encoder_layers=24,
        encoder_seq=1500,
        encoder_d_model=1024,
        use_layernorm=True,
        act="gelu",
        glu=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, encoder_layers=2, encoder_seq=16,
        encoder_d_model=128)
