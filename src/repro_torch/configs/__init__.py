"""Architecture config registry of the port: ``get_config(arch_id)`` /
``get_reduced``, with the JAX package's ids.

The registry lists only the architectures whose every block kind the port
builds. The JAX package's other ids raise, naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

from repro_torch.common.config import ModelConfig
from repro_torch.configs import recurrentgemma_9b

_REGISTRY = {
    recurrentgemma_9b.ID: (recurrentgemma_9b.config,
                           recurrentgemma_9b.reduced),
}

# the JAX package's architectures the port cannot build yet
_NOT_PORTED = (
    "deepseek-v2-lite-16b", "stablelm-1.6b", "paligemma-3b",
    "whisper-medium", "rwkv6-1.6b", "deepseek-v2-236b", "qwen3-4b",
    "qwen3-4b-sw", "yi-34b", "codeqwen1.5-7b",
)

ALL_ARCHS = list(_REGISTRY)


def _lookup(arch: str):
    if arch in _REGISTRY:
        return _REGISTRY[arch]
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not in the port yet: its block kinds "
            "and families come with ROADMAP A11c (serving RecurrentGemma "
            "is A11a)")
    raise KeyError(f"unknown architecture {arch!r} (ported: {ALL_ARCHS})")


def get_config(arch: str) -> ModelConfig:
    return _lookup(arch)[0]()


def get_reduced(arch: str) -> ModelConfig:
    return _lookup(arch)[1]()
