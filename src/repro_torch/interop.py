"""Carrying arrays from the JAX package (or any numpy source) into the
port, under the JAX package's dtype rules.

JAX runs with 64-bit types off, so a float64 numpy array becomes a
float32 device array on upload (and int64 int32, complex128 complex64).
The port's ``send_matrix`` and ``engine.put`` apply the same rule through
:func:`host_to_tensor`, or handle dtypes and CG tolerances would diverge
from the reference. ml_dtypes ``bfloat16`` arrays — what ``np.asarray``
gives for a JAX bf16 array — cross through an int16 view, because
``torch.from_numpy`` refuses them.
"""
from __future__ import annotations

import numpy as np
import torch

# JAX's canonical dtypes with 64-bit types off
_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def canonical_dtype(dtype) -> np.dtype:
    """The dtype a host array of ``dtype`` has once uploaded."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


def host_to_tensor(array, device) -> torch.Tensor:
    """One host array as a tensor on ``device``, in its canonical dtype."""
    a = np.asarray(array)
    if not a.flags.writeable:         # e.g. a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    dt = canonical_dtype(a.dtype)
    if dt != a.dtype:
        a = a.astype(dt)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a host ndarray. bfloat16 widens to
    float32: numpy has no bfloat16 of its own."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def from_reference(arrays: dict[str, np.ndarray],
                   device) -> dict[str, torch.Tensor]:
    """The JAX package's arrays (as numpy) as the port's tensors on
    ``device``, name for name."""
    return {k: host_to_tensor(v, device) for k, v in arrays.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by its numpy/JAX name (``torch.float32`` ->
    ``"float32"``), as handles and wire frames spell it."""
    return str(dtype).removeprefix("torch.")
