"""Public wrapper of the normal-equations matvec. The device decides: the
plain version for a CPU tensor, a CUDA kernel for a CUDA tensor — at any
d (the TPU wrapper's d <= 8192 cap has no counterpart here). On the card
the call's shape picks the kernel (:func:`route`): the one-pass stream
route for narrow w, where X's bytes bound the call, the tensor-core route
for the rest."""
from __future__ import annotations

import torch

from repro_torch.common import spans
from repro_torch.kernels import device
from repro_torch.kernels.normal_matvec.normal_matvec import (
    STREAM_MAX_D, normal_matvec_cuda, normal_matvec_stream_cuda)
from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref

LAUNCHES = device.LaunchCounter()
#: launches of the stream route (``csrc/normal_matvec_stream.cu``)
STREAM_LAUNCHES = device.LaunchCounter()


def route(d: int, c: int, dtype) -> str:
    """The kernel a CUDA call with X (n, d) of ``dtype`` and w (d, c)
    takes: ``"stream"`` (one pass over X) for one column of w and rows of
    at most ``STREAM_MAX_D``, which the stream kernel's register sums
    hold, else ``"wgmma"`` (3xTF32 on the tensor cores, two passes). Any
    n takes either."""
    stream = c == 1 and d <= STREAM_MAX_D and dtype in device.FLOAT_INPUTS
    return "stream" if stream else "wgmma"


def normal_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w -> X^T (X w) with fp32 accumulation; x (n, d) fp32/bf16, w (d, c)
    fp32, both contiguous. Returns (d, c) fp32."""
    device.require_matrix("normal_matvec", "x", x)
    device.require_matrix("normal_matvec", "w", w, (torch.float32,))
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"normal_matvec: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    with device.kernel_span("normal_matvec", x, w):
        if device.on_cpu("normal_matvec", x, w):
            return normal_matvec_ref(x, w)
        n, d = x.shape
        c = w.shape[1]
        device.require_nonempty("normal_matvec", n=n, d=d, c=c)
        if route(d, c, x.dtype) == "stream":
            out = normal_matvec_stream_cuda(x, w)
            STREAM_LAUNCHES.add()
            spans.count("nm_stream")
            return out
        out = normal_matvec_cuda(x, w)
        LAUNCHES.add()
        return out
