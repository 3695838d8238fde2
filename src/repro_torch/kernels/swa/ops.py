"""Public wrapper of sliding-window causal attention. The device decides:
the plain version for a CPU tensor, the CUDA kernel for a CUDA tensor.
Forward only, as the TPU kernel: it serves prefill."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.swa.ref import swa_ref
from repro_torch.kernels.swa.swa import swa_cuda

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (32, 64, 128, 256)

#: kernel launches (CUDA tensors only)
LAUNCHES = device.LaunchCounter()


def _tiles_align(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary: the bf16 kernel
    copies 16-byte chunks (cp.async)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Causal attention over keys in (pos - window, pos]. q: (B, H, S, D);
    k, v: (B, K, S, D) with H % K == 0, all fp32 or all bf16; GQA maps head
    h to kv head h // (H // K). Any S and any window >= 1 (window >= S is
    causal attention). On CUDA the last axis must be contiguous; other
    strides are free, so (B, S, H, D) tensors pass as
    ``x.transpose(1, 2)`` views; in bf16 they must keep rows 16-byte
    aligned. fp32 runs on the CUDA cores, bf16 on the tensor cores with
    the probabilities split into bf16 hi and lo parts for the product
    with v."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        device.require_tensor("swa", name, t, 4, contiguous=False)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"swa: q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if tuple(k.shape) != (b, kh, s, d) or v.shape != k.shape:
        raise ValueError(f"swa: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (B, H, S, D), "
                         "(B, K, S, D), (B, K, S, D)")
    if kh < 1 or h % kh:
        raise ValueError(f"swa: {h} query heads are not a multiple of {kh} "
                         "kv heads")
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"swa: window must be an int >= 1, got {window!r}")
    if device.on_cpu("swa", q, k, v):
        return swa_ref(q, k, v, window)
    device.require_nonempty("swa", B=b, H=h, S=s)
    if d not in HEAD_DIMS:
        raise ValueError(f"swa: head_dim {d} not in {HEAD_DIMS} on CUDA")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("swa: the head_dim axis of q, k, v must be "
                         "contiguous on CUDA")
    if q.dtype == torch.bfloat16 and not all(_tiles_align(t)
                                             for t in (q, k, v)):
        raise ValueError("swa: bf16 on CUDA takes 16-byte aligned q, k, v "
                         "whose batch, head and position strides are "
                         "multiples of 8 elements (16-byte tile copies)")
    device.require_grid("swa", batch_heads=b * h)
    out = swa_cuda(q, k, v, window)
    LAUNCHES.add()
    return out
