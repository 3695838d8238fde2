"""Launchers of the CUDA sliding-window attention and its backward
(``repro_torch/csrc/swa.cu``, ``repro_torch/csrc/swa_bwd.cu``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, device


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int, with_lse: bool = False, prefix: int = 0,
             out32: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sliding-window causal attention on the card, the first ``prefix``
    positions bidirectional among themselves. q (B, H, S, D), k and v
    (B, K, S, D), one type (fp32/bf16), any strides with D contiguous.
    Returns (out, lse): out in q's type, laid out like q (``empty_like``),
    so a (B, S, H, D) buffer viewed as (B, H, S, D) comes back as such a
    view; with ``with_lse`` each row's log-sum-exp, fp32 contiguous
    (B, H, S), else None (nothing more is written). ``out32`` (bf16 only:
    fp32 contiguous (B, H, S, D)) also receives the output before it is
    rounded. bf16 runs on the warpgroup kernel of ``csrc/swa.cu``, which
    rounds the probabilities once to fp16 against an fp16 copy of v scaled
    by a power of two per (batch, kv head): that copy (B, K, S, D) and the
    max |v| it is scaled by are scratch allocated here and written by the
    launch, on the tensors' stream."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    bf16 = q.dtype == torch.bfloat16
    v16 = torch.empty((b, kh, s, d), dtype=torch.float16,
                      device=q.device) if bf16 else None
    vmax = torch.empty((b, kh), dtype=torch.int32, device=q.device) \
        if bf16 else None
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = build.load("swa")
    with torch.cuda.device(q.device):
        err = lib.swa_launch(device.dtype_code(q), d, q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                             h, kh, s, strides, window, prefix, d ** -0.5,
                             v16.data_ptr() if v16 is not None else None,
                             vmax.data_ptr() if vmax is not None else None,
                             lse.data_ptr() if lse is not None else None,
                             out32.data_ptr() if out32 is not None else None,
                             device.stream_ptr(q))
    build.check("swa", err)
    return out, lse


#: the bf16 dK/dV kernel splits a kv head's query heads over at most this
#: many blocks per key tile (MQA's 16 heads to 1: four times the blocks)
KV_SPLITS = 4

#: rows and stages of the bf16 backward's tiles by head dim, as
#: ``csrc/swa_bwd.cu``'s DqTile and KvTile set them: the dQ kernel's
#: queries a block, keys a step and stages; the dK/dV kernel's keys a
#: block, queries a step and stages (128 keys a block where each consumer
#: owns 64 of them with both sums, D <= 64)
BWD_TILES = {d: {"dq": (128, 32 if d == 256 else 64, 3),
                 "dkdv": (128 if d <= 64 else 64, 64, 2 if d == 256 else 3)}
             for d in (32, 64, 128, 256)}


def kv_splits(group: int) -> int:
    """Blocks a kv head's ``group`` query heads are split over in the bf16
    dK/dV kernel: up to :data:`KV_SPLITS`, each taking ceil(group /
    splits) heads, none empty."""
    per = -(-group // min(group, KV_SPLITS))
    return -(-group // per)


def swa_bwd_route(t: torch.Tensor) -> str:
    """The route ``csrc/swa_bwd.cu`` takes for ``t``'s dtype, as its
    launcher reports it (``swa_bwd_route``, the function it dispatches
    on): ``"tensor_cores"`` or ``"cuda_cores"``. Builds the kernel if
    needed."""
    code = build.load("swa_bwd").swa_bwd_route(device.dtype_code(t))
    return "tensor_cores" if code == 1 else "cuda_cores"


def swa_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                 window: int, prefix: int = 0) -> tuple:
    """dQ, dK, dV of :func:`swa_cuda` on the card, from its inputs, its
    output before rounding ``o`` (fp32), its ``lse`` (fp32 contiguous
    (B, H, S)) and the output's gradient ``dout`` (q's shape and type).
    Every tensor D-contiguous,
    other strides free (bf16: rows 16-byte aligned). Returns the three
    gradients in the input type, each laid out like its input. In bf16,
    where a kv head's query heads are split over more than one dK/dV
    block, the splits' partials go to an fp32 scratch of 2 x splits x K's
    size."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    splits = kv_splits(h // kh)
    part = torch.empty((2, splits, b, kh, s, d), dtype=torch.float32,
                       device=q.device) \
        if q.dtype == torch.bfloat16 and splits > 1 else None
    strides = (ctypes.c_int64 * 24)(*(
        st for t in (q, k, v, o, dout, dq, dk, dv) for st in t.stride()[:3]))
    lib = build.load("swa_bwd")
    with torch.cuda.device(q.device):
        err = lib.swa_bwd_launch(
            device.dtype_code(q), d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            part.data_ptr() if part is not None else None, b, h, kh, s,
            splits, strides, window, prefix, d ** -0.5, device.stream_ptr(q))
    build.check("swa_bwd", err)
    return dq, dk, dv
