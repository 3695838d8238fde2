"""Public wrappers of sliding-window causal attention and its backward.
The device decides: the plain versions for CPU tensors, the CUDA kernels
for CUDA tensors. A ``prefix`` P makes the first P positions attend to
each other in both directions (the JAX package's prefix-LM mask); P = S
with window = S is bidirectional attention.

:func:`swa_attention` is differentiable. Where autograd records (grad mode
on and an input that requires a gradient) it runs as the
``torch.autograd.Function`` :class:`SwaFunction`, whose forward also
writes each row's log-sum-exp and, in bf16, its output before rounding,
and whose backward is :func:`swa_backward` (``csrc/swa_bwd.cu`` on the
card, the prefix included): no caller can get an output cut off from its
inputs' gradients. Elsewhere (serving runs under
``torch.inference_mode``) it launches the forward kernel alone and writes
neither. The TPU kernel is forward-only; the JAX package differentiates
its XLA attention.

Meta tensors (the dry run, ``launch/dryrun.py``) take a shape rule: empty
outputs of the kernels' shapes and dtypes, nothing computed; no CPU or
CUDA tensor reaches it."""

from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.swa.ref import swa_backward_ref, swa_forward_ref, \
    swa_ref
from repro_torch.kernels.swa.swa import swa_bwd_cuda, swa_cuda

#: head dims the CUDA kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)

#: forward kernel launches (CUDA tensors only)
LAUNCHES = device.LaunchCounter()
#: backward kernel launches (CUDA tensors only)
BWD_LAUNCHES = device.LaunchCounter()
#: of those, the launches with a prefix (PaliGemma's patches, Whisper's
#: encoder): a sub-count, outside ``kernels.launch_counters()``
BWD_PREFIX_LAUNCHES = device.LaunchCounter()


def _tiles_align(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary: the bf16 kernels
    load tiles by TMA (the forward) and 16-byte cp.async chunks (the
    backward)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _check(q, k, v, window, prefix=0) -> None:
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
    if isinstance(prefix, bool) or not isinstance(prefix, int) or \
            not 0 <= prefix <= s:
        raise ValueError(f"swa: prefix must be an int in [0, S = {s}], got "
                         f"{prefix!r}")


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    """What the CUDA kernels take: no empty dimension, a head dim they are
    instantiated for, D contiguous, B * H within a grid's y axis."""
    b, h, s, d = ts[0].shape
    device.require_nonempty(what, B=b, H=h, S=s)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS} on CUDA")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{what}: the head_dim axis of every operand must "
                         "be contiguous on CUDA")
    device.require_grid(what, batch_heads=b * h)


def swa_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, with_lse: bool = False, prefix: int = 0):
    """The forward without autograd: (out, lse, o32), operands as
    :func:`swa_attention`'s. Without ``with_lse`` lse and o32 are None.
    With it, lse is each row's log-sum-exp of its scaled, masked scores,
    fp32 (B, H, S), and o32 the output before it is rounded to q's type,
    fp32 contiguous (the output itself when that is fp32): the two
    tensors :func:`swa_backward` takes besides the inputs."""
    _check(q, k, v, window, prefix)
    f32 = q.dtype == torch.float32
    if device.on_meta("swa", q, k, v):
        out = torch.empty_like(q)
        if not with_lse:
            return out, None, None
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
        return out, lse, out if f32 else torch.empty_like(
            out, dtype=torch.float32)
    if device.on_cpu("swa", q, k, v):
        if not with_lse:
            return swa_ref(q, k, v, window, prefix), None, None
        out32, lse = swa_forward_ref(q.float(), k.float(), v.float(),
                                     window, prefix)
        return out32.to(q.dtype), lse, out32
    _check_cuda("swa", q, k, v)
    if not f32 and not all(_tiles_align(t) for t in (q, k, v)):
        raise ValueError("swa: bf16 on CUDA takes 16-byte aligned q, k, v "
                         "whose batch, head and position strides are "
                         "multiples of 8 elements (TMA tile loads)")
    if not f32:
        # the bf16 kernel's grid: (B H, query tiles of 128)
        device.require_grid("swa", query_tiles=-(-q.shape[2] // 128))
    out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
        if with_lse and not f32 else None
    out, lse = swa_cuda(q, k, v, window, with_lse, prefix, out32)
    LAUNCHES.add()
    if not with_lse:
        return out, None, None
    return out, lse, out if f32 else out32


class SwaFunction(torch.autograd.Function):
    """Sliding-window attention with its gradient: the forward kernel,
    writing lse and the output before rounding, then
    :func:`swa_backward`, which reads D = rowsum(dO o) from that fp32
    output: from the bf16 o, dQ at whisper-medium's encoder came out 13 to
    999 % of its norm from the fp32 gradient on an NVIDIA H100, where
    attention over similar frames is near uniform and dP - D nearly
    cancels. On the CPU both plain versions compute in fp32 and round
    once to the input type."""

    @staticmethod
    def forward(ctx, q, k, v, window, prefix=0):
        out, lse, o32 = swa_forward(q, k, v, window, with_lse=True,
                                    prefix=prefix)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.window = window
        ctx.prefix = prefix
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        return (*swa_backward(q, k, v, o32, lse, dout, window=ctx.window,
                              prefix=ctx.prefix), None, None)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, prefix: int = 0) -> torch.Tensor:
    """Causal attention over keys in (pos - window, pos], where the first
    ``prefix`` positions also see each other in both directions: key j is
    visible to query i when (j <= i or j, i < prefix) and j > i - window.
    q: (B, H, S, D); k, v: (B, K, S, D) with H % K == 0, all fp32 or all
    bf16; GQA maps head h to kv head h // (H // K). Any S, any window >= 1
    (window >= S is causal attention) and any prefix in [0, S] (prefix =
    window = S is bidirectional attention). On CUDA the last axis must be
    contiguous; other
    strides are free, so (B, S, H, D) tensors pass as
    ``x.transpose(1, 2)`` views; in bf16 they must keep rows 16-byte
    aligned. fp32 runs on the CUDA cores; bf16 on Hopper's tensor cores
    (``csrc/swa.cu``: wgmma products on tiles that TMA brings, a producer
    and two consumer warpgroups), with the probabilities rounded once to
    fp16 for the product with v, which is taken to fp16 after a
    power-of-two scale per (batch, kv head): within one bf16 ulp plus 1e-2
    of the output's RMS of the fp32 attention, bounded by the consumers'
    softmax more than by the products. Differentiable: see the module's
    docstring."""
    # both routes check their operands in swa_forward (a second check
    # here cost 27 µs of host time a call beside an H100)
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in (q, k, v)):
        return SwaFunction.apply(q, k, v, window, prefix)
    return swa_forward(q, k, v, window, prefix=prefix)[0]


def swa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                 window: int, prefix: int = 0) -> tuple:
    """(dQ, dK, dV) of :func:`swa_attention`, given its inputs, its output
    ``o``, its fp32 (B, H, S) log-sum-exp ``lse`` and ``dout``, the
    gradient of the output (q's shape and type; any strides: one not
    contiguous in D, or in bf16 with rows not 16-byte aligned, is copied).
    ``o`` is fp32: the forward's output before rounding,
    :func:`swa_forward`'s o32 (the kernel reads D = rowsum(dO o) from it).
    The plain version for CPU tensors, the kernels of ``csrc/swa_bwd.cu``
    for CUDA tensors, the prefix's mask included: fp32 on the CUDA cores, bf16 on
    the tensor cores (P and dS rounded to bf16 as operands of their
    products), where q, k and v must keep rows 16-byte aligned as in the
    forward. Gradients come back in the input type, each laid out like
    its input."""
    _check(q, k, v, window, prefix)
    device.require_tensor("swa_bwd", "o", o, 4, contiguous=False)
    device.require_tensor("swa_bwd", "dout", dout, 4, contiguous=False)
    device.require_tensor("swa_bwd", "lse", lse, 3, (torch.float32,))
    if o.shape != q.shape or dout.shape != q.shape or \
            dout.dtype != q.dtype or o.dtype != torch.float32:
        raise ValueError(f"swa_bwd: o {tuple(o.shape)} {o.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} are not q's "
                         f"{tuple(q.shape)} {q.dtype} (o in fp32)")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"swa_bwd: lse {tuple(lse.shape)} is not (B, H, S)"
                         f" = {tuple(q.shape[:3])}")
    if device.on_meta("swa_bwd", q, k, v, o, lse, dout):
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if device.on_cpu("swa_bwd", q, k, v, o, lse, dout):
        return swa_backward_ref(q, k, v, o, lse, dout, window, prefix)
    bf16 = q.dtype == torch.bfloat16
    if dout.stride(-1) != 1 or (bf16 and not _tiles_align(dout)):
        dout = dout.contiguous()
    _check_cuda("swa_bwd", q, k, v, o, dout)
    device.require_grid("swa_bwd", key_tiles=-(-q.shape[2] // 64))
    if bf16 and not all(_tiles_align(t) for t in (q, k, v)):
        raise ValueError("swa_bwd: bf16 on CUDA takes 16-byte aligned q, "
                         "k, v whose batch, head and position strides are "
                         "multiples of 8 elements (16-byte tile copies)")
    grads = swa_bwd_cuda(q, k, v, o, lse, dout, window, prefix)
    BWD_LAUNCHES.add()
    if prefix:
        BWD_PREFIX_LAUNCHES.add()
    return grads
