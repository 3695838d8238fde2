"""Public wrappers of sliding-window causal attention and its backward.
The device decides: the plain versions for CPU tensors, the CUDA kernels
for CUDA tensors. A ``prefix`` P makes the first P positions attend to
each other in both directions (the JAX package's prefix-LM mask); P = S
with window = S is bidirectional attention.

:func:`swa_attention` is differentiable. Where autograd records (grad mode
on and an input that requires a gradient) it runs as the
``torch.autograd.Function`` :class:`SwaFunction`, whose forward also
writes each row's log-sum-exp and whose backward is
:func:`swa_backward` (``csrc/swa_bwd.cu`` on the card): no caller can get
an output cut off from its inputs' gradients. Elsewhere (serving runs
under ``torch.inference_mode``) it launches the forward kernel alone and
writes no log-sum-exp. The TPU kernel is forward-only; the JAX package
differentiates its XLA attention. The backward kernel does not take a
prefix yet (ROADMAP B.7): with ``prefix > 0`` on CUDA tensors autograd and
:func:`swa_backward` raise ``NotImplementedError``, never a plain
fallback; on the CPU the plain backward honours the prefix."""

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


def _tiles_align(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary: the bf16 kernel
    copies 16-byte chunks (cp.async)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


#: what a prefix under autograd on CUDA raises: csrc/swa_bwd.cu has no
#: prefix mask yet
PREFIX_BACKWARD = ("swa_bwd: the backward kernel does not take a prefix "
                   "mask yet (ROADMAP B.7); training a prefix-LM or an "
                   "encoder on the card waits for it")


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
    """The forward without autograd: (out, lse or None), operands as
    :func:`swa_attention`'s. With ``with_lse`` it also returns each row's
    log-sum-exp of its scaled, masked scores, fp32 (B, H, S), which
    :func:`swa_backward` takes."""
    _check(q, k, v, window, prefix)
    if device.on_cpu("swa", q, k, v):
        if with_lse:
            return swa_forward_ref(q, k, v, window, prefix)
        return swa_ref(q, k, v, window, prefix), None
    _check_cuda("swa", q, k, v)
    if q.dtype == torch.bfloat16 and not all(_tiles_align(t)
                                             for t in (q, k, v)):
        raise ValueError("swa: bf16 on CUDA takes 16-byte aligned q, k, v "
                         "whose batch, head and position strides are "
                         "multiples of 8 elements (16-byte tile copies)")
    out, lse = swa_cuda(q, k, v, window, with_lse, prefix)
    LAUNCHES.add()
    return out, lse


class SwaFunction(torch.autograd.Function):
    """Sliding-window attention with its gradient: the forward kernel
    (writing lse), then :func:`swa_backward`. With a prefix on CUDA
    tensors it raises before launching anything (ROADMAP B.7)."""

    @staticmethod
    def forward(ctx, q, k, v, window, prefix=0):
        ctx.cpu, ctx.dtype = device.on_cpu("swa", q, k, v), q.dtype
        if ctx.cpu:
            # the plain versions compute in fp32 whatever the input type:
            # run them on fp32 copies and round the output (and, in the
            # backward, each gradient) to the input type once, so that
            # the backward's D = rowsum(dO o) reads the unrounded output
            # (a bf16 o loses gradients that nearly cancel, as over an
            # encoder's near-uniform attention)
            q, k, v = q.float(), k.float(), v.float()
        elif prefix:
            raise NotImplementedError(PREFIX_BACKWARD)
        out, lse = swa_forward(q, k, v, window, with_lse=True, prefix=prefix)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        ctx.prefix = prefix
        return out.to(ctx.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.cpu:
            dout = dout.float()
        grads = swa_backward(q, k, v, out, lse, dout, window=ctx.window,
                             prefix=ctx.prefix)
        return (*(g.to(ctx.dtype) for g in grads), None, None)


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
    aligned. fp32 runs on the CUDA cores, bf16 on the tensor cores with
    the probabilities split into bf16 hi and lo parts for the product
    with v. Differentiable: see the module's docstring."""
    _check(q, k, v, window, prefix)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return SwaFunction.apply(q, k, v, window, prefix)
    return swa_forward(q, k, v, window, prefix=prefix)[0]


def swa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                 window: int, prefix: int = 0) -> tuple:
    """(dQ, dK, dV) of :func:`swa_attention`, given its inputs, its output
    ``o``, its fp32 (B, H, S) log-sum-exp ``lse`` and ``dout``, the
    gradient of ``o`` (o's shape and type; any strides: one not contiguous
    in D, or in bf16 with rows not 16-byte aligned, is copied). The plain
    version for CPU tensors, the kernels of ``csrc/swa_bwd.cu`` for CUDA
    tensors: fp32 on the CUDA cores, bf16 on the tensor cores (P and dS
    rounded to bf16 as operands of their products), where q, k and v
    must keep rows 16-byte aligned as in the forward. Gradients come back
    in the input type, each laid out like its input. A ``prefix`` runs on
    the CPU only: on CUDA tensors it raises ``NotImplementedError``
    (ROADMAP B.7)."""
    _check(q, k, v, window, prefix)
    device.require_tensor("swa_bwd", "o", o, 4, contiguous=False)
    device.require_tensor("swa_bwd", "dout", dout, 4, contiguous=False)
    device.require_tensor("swa_bwd", "lse", lse, 3, (torch.float32,))
    if o.shape != q.shape or dout.shape != q.shape or \
            not (o.dtype == dout.dtype == q.dtype):
        raise ValueError(f"swa_bwd: o {tuple(o.shape)} {o.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} are not q's "
                         f"{tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"swa_bwd: lse {tuple(lse.shape)} is not (B, H, S)"
                         f" = {tuple(q.shape[:3])}")
    if device.on_cpu("swa_bwd", q, k, v, o, lse, dout):
        return swa_backward_ref(q, k, v, o, lse, dout, window, prefix)
    if prefix:
        raise NotImplementedError(PREFIX_BACKWARD)
    bf16 = q.dtype == torch.bfloat16
    if dout.stride(-1) != 1 or (bf16 and not _tiles_align(dout)):
        dout = dout.contiguous()
    _check_cuda("swa_bwd", q, k, v, o, dout)
    device.require_grid("swa_bwd", key_tiles=-(-q.shape[2] // 64))
    if bf16 and not all(_tiles_align(t) for t in (q, k, v)):
        raise ValueError("swa_bwd: bf16 on CUDA takes 16-byte aligned q, "
                         "k, v whose batch, head and position strides are "
                         "multiples of 8 elements (16-byte tile copies)")
    grads = swa_bwd_cuda(q, k, v, o, lse, dout, window)
    BWD_LAUNCHES.add()
    return grads
