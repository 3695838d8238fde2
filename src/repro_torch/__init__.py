"""repro_torch — the PyTorch/CUDA port of the Alchemist offload engine.

The JAX package ``repro`` is the reference; this package does what it does
with PyTorch, on one NVIDIA H100 (``device="cuda"``, the default) or, when
a caller asks for it, on the CPU (``device="cpu"``). It imports neither
``jax`` nor ``repro``. The client entry point is
``repro_torch.core.AlchemistContext``; the hand-written CUDA kernels are
under ``repro_torch.kernels`` with their sources in ``repro_torch/csrc``.
"""
