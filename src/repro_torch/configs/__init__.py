"""Architecture config registry of the port: ``get_config(arch_id)`` /
``get_reduced``, with the JAX package's ids, and its ``ASSIGNED`` list,
``supports_shape`` and ``shape_by_name``.

The registry lists every architecture of the JAX package: RecurrentGemma,
the decoder-only text families (dense, RWKV6, MLA with MoE), the prefix-LM
VLM (PaliGemma) and the encoder-decoder (Whisper).
"""
from __future__ import annotations

from repro_torch.common.config import ModelConfig, SHAPES, ShapeConfig
from repro_torch.configs import (
    codeqwen1_5_7b,
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    paligemma_3b,
    qwen3_4b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    stablelm_1_6b,
    whisper_medium,
    yi_34b,
)

_REGISTRY = {
    recurrentgemma_9b.ID: (recurrentgemma_9b.config,
                           recurrentgemma_9b.reduced),
    deepseek_v2_lite_16b.ID: (deepseek_v2_lite_16b.config,
                              deepseek_v2_lite_16b.reduced),
    stablelm_1_6b.ID: (stablelm_1_6b.config, stablelm_1_6b.reduced),
    paligemma_3b.ID: (paligemma_3b.config, paligemma_3b.reduced),
    whisper_medium.ID: (whisper_medium.config, whisper_medium.reduced),
    rwkv6_1_6b.ID: (rwkv6_1_6b.config, rwkv6_1_6b.reduced),
    deepseek_v2_236b.ID: (deepseek_v2_236b.config, deepseek_v2_236b.reduced),
    qwen3_4b.ID: (qwen3_4b.config, qwen3_4b.reduced),
    qwen3_4b.ID_SW: (qwen3_4b.config_sw, qwen3_4b.reduced_sw),
    yi_34b.ID: (yi_34b.config, yi_34b.reduced),
    codeqwen1_5_7b.ID: (codeqwen1_5_7b.config, codeqwen1_5_7b.reduced),
}

# The 10 assigned architecture ids (qwen3-4b-sw is a variant, not
# assigned), as the JAX package lists them.
ASSIGNED = [
    recurrentgemma_9b.ID,
    deepseek_v2_lite_16b.ID,
    stablelm_1_6b.ID,
    paligemma_3b.ID,
    whisper_medium.ID,
    rwkv6_1_6b.ID,
    deepseek_v2_236b.ID,
    qwen3_4b.ID,
    yi_34b.ID,
    codeqwen1_5_7b.ID,
]

ALL_ARCHS = list(_REGISTRY)


def _lookup(arch: str):
    if arch in _REGISTRY:
        return _REGISTRY[arch]
    raise KeyError(f"unknown architecture {arch!r} (ported: {ALL_ARCHS})")


def get_config(arch: str) -> ModelConfig:
    return _lookup(arch)[0]()


def get_reduced(arch: str) -> ModelConfig:
    return _lookup(arch)[1]()


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is runnable.

    long_500k needs sub-quadratic attention: SSM/hybrid/sliding-window only.
    """
    if shape.name == "long_500k":
        return cfg.supports_long_context()
    return True


def shape_by_name(name: str) -> ShapeConfig:
    return SHAPES[name]
