"""Public wrappers of the gated linear recurrence, forward and reversed in
time. The device decides: the plain versions for CPU tensors, the CUDA
kernel for CUDA tensors.

:func:`lru_scan` is differentiable. Where autograd records (grad mode on
and an input that requires a gradient) it runs as the
``torch.autograd.Function`` :class:`LruScanFunction`, whose backward runs
the adjoint recurrence through :func:`lru_scan_reverse` (the same CUDA
kernel launched reversed on the card, writing a's gradient in the same
pass): no caller can get states cut off from their inputs' gradients.
Elsewhere (serving runs under ``torch.inference_mode``) it launches the
forward kernel alone. The TPU kernel is forward-only; the JAX package
differentiates ``jax.lax.associative_scan``.

Meta tensors (the dry run, ``launch/dryrun.py``) take a shape rule: empty
fp32 states (and da) of the kernel's shapes, nothing computed; no CPU or
CUDA tensor reaches it."""
from __future__ import annotations

import torch

from repro_torch.kernels import device
from repro_torch.kernels.lru_scan.lru_scan import CHUNK, lru_scan_cuda
from repro_torch.kernels.lru_scan.ref import lru_scan_ref, \
    lru_scan_reverse_ref

#: forward kernel launches (CUDA tensors only)
LAUNCHES = device.LaunchCounter()
#: reverse kernel launches (CUDA tensors only)
REVERSE_LAUNCHES = device.LaunchCounter()


def _check(what: str, a, b, h0) -> None:
    for name, t in (("a", a), ("b", b)):
        device.require_tensor(what, name, t, 3)
    device.require_tensor(what, "h0", h0, 2, (torch.float32,))
    if b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(f"{what}: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype} differ")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"{what}: h0 {tuple(h0.shape)} is not (B, W) = "
                         f"{(a.shape[0], a.shape[2])}")


def _check_cuda(what: str, a) -> None:
    b, s, w = a.shape
    device.require_nonempty(what, B=b, S=s, W=w)
    # one block per chunk of CHUNK steps x 32 channels of a batch row, on
    # the grid's x axis
    device.require_grid(what, blocks=b * -(-w // 32) * -(-s // CHUNK),
                        axis="x")


def _scan(a, b, h0) -> torch.Tensor:
    if device.on_meta("lru_scan", a, b, h0):
        return torch.empty(a.shape, dtype=torch.float32, device="meta")
    if device.on_cpu("lru_scan", a, b, h0):
        return lru_scan_ref(a, b, h0)
    _check_cuda("lru_scan", a)
    out = lru_scan_cuda(a, b, h0)
    LAUNCHES.add()
    return out


class LruScanFunction(torch.autograd.Function):
    """The recurrence with its gradient. With lambda the adjoint,
    lambda_t = g_t + a_{t+1} lambda_{t+1} (a reverse scan from a zero
    carry): db_t = lambda_t, da_t = lambda_t h_{t-1} (h_{-1} = h0),
    dh0 = a_0 lambda_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        # the kernel takes a and b of one type: the gradient is fp32
        af = a if a.dtype == torch.float32 else a.float()
        g, zero = g.float().contiguous(), torch.zeros_like(h0)
        da = db = dh0 = None
        if ctx.needs_input_grad[0]:
            # the same pass writes da_t = lambda_t h_{t-1}
            lam, da = lru_scan_reverse(af, g, zero, h=h, h_init=h0)
            da = da.to(a.dtype)
        else:
            lam = lru_scan_reverse(af, g, zero)
        if ctx.needs_input_grad[1]:
            db = lam.to(a.dtype)            # b's type is a's
        if ctx.needs_input_grad[2]:
            dh0 = af[:, 0] * lam[:, 0]
        return da, db, dh0


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over (B, S, W) from h0 (B, W); returns
    every state, (B, S, W) fp32. ``a`` and ``b`` are contiguous fp32 or
    bf16 of one type; ``h0`` is contiguous fp32. Any S and W.
    Differentiable: see the module's docstring."""
    _check("lru_scan", a, b, h0)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return LruScanFunction.apply(a, b, h0)
    return _scan(a, b, h0)


def lru_scan_reverse(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                     h: torch.Tensor | None = None,
                     h_init: torch.Tensor | None = None):
    """y_t = a_{t+1} y_{t+1} + b_t for t = S - 1 .. 0, the carry ``h0``
    entering the last step unscaled (y_{S-1} = h0 + b_{S-1}); returns
    every y, (B, S, W) fp32. Operands as :func:`lru_scan`'s. With b the
    gradient of the states and h0 zero, y is the adjoint of
    :func:`lru_scan`. Given ``h`` (the forward's states, contiguous
    (B, S, W) fp32) and ``h_init`` (its h0, (B, W) fp32), returns
    (y, da) with da_t = y_t h_{t-1} (h_{-1} = h_init), from the same
    launch on the card."""
    _check("lru_scan_reverse", a, b, h0)
    if (h is None) != (h_init is None):
        raise ValueError("lru_scan_reverse: h and h_init come together")
    tensors = (a, b, h0)
    if h is not None:
        device.require_tensor("lru_scan_reverse", "h", h, 3,
                              (torch.float32,))
        device.require_tensor("lru_scan_reverse", "h_init", h_init, 2,
                              (torch.float32,))
        if h.shape != a.shape or h_init.shape != h0.shape:
            raise ValueError(f"lru_scan_reverse: h {tuple(h.shape)} and "
                             f"h_init {tuple(h_init.shape)} are not a's "
                             f"{tuple(a.shape)} and h0's "
                             f"{tuple(h0.shape)}")
        tensors += (h, h_init)
    if device.on_meta("lru_scan_reverse", *tensors):
        y = torch.empty(a.shape, dtype=torch.float32, device="meta")
        return y if h is None else (y, torch.empty_like(y))
    if device.on_cpu("lru_scan_reverse", *tensors):
        return lru_scan_reverse_ref(a, b, h0, h, h_init)
    _check_cuda("lru_scan_reverse", a)
    out = lru_scan_cuda(a, b, h0, reverse=True, h=h, h_init=h_init)
    REVERSE_LAUNCHES.add()
    return out
