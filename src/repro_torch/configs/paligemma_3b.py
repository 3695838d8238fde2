"""PaliGemma-3B [arXiv:2407.07726] — prefix-LM VLM: SigLIP vision encoder
(STUB: input_specs supplies precomputed patch embeddings) + Gemma-2B decoder.

18 layers, d_model=2048, 8 heads (MQA kv=1, head_dim 256), d_ff=16384,
vocab 257216, 256 image-patch prefix with bidirectional attention.
"""
import dataclasses

from repro_torch.common.config import AttentionKind, ModelConfig

ID = "paligemma-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257_216,
        attention_kind=AttentionKind.PREFIX,
        prefix_len=256,
        act="gelu_tanh",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512, prefix_len=8)
