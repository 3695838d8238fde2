"""Carrying arrays from the JAX package (or any numpy source) into the
port, under the JAX package's dtype rules.

JAX runs with 64-bit types off, so a float64 numpy array becomes a
float32 device array on upload (and int64 int32, complex128 complex64).
The port's ``send_matrix`` and ``engine.put`` apply the same rule through
:func:`host_to_tensor`, or handle dtypes and CG tolerances would diverge
from the reference. ml_dtypes ``bfloat16`` arrays — what ``np.asarray``
gives for a JAX bf16 array — cross through an int16 view, because
``torch.from_numpy`` refuses them, and a bfloat16 tensor goes back out
the same way (:func:`tensor_to_numpy`), so a bf16 store crosses to the
client as bf16, at its own width, as the JAX package hands it out.

:func:`lm_params_from_reference` carries a JAX ``DecoderLM``'s parameters
into the port's ``DecoderLM``, and :func:`adamw_state_from_reference` the
JAX package's AdamW state of such parameters into the port's.
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


def numpy_dtype(name) -> np.dtype:
    """A numpy dtype by its name, ``"bfloat16"`` included: that one is
    ml_dtypes', imported only when a bfloat16 crosses (ImportError where
    ml_dtypes is absent; nothing widens in its place)."""
    if str(name) == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a host ndarray of its own dtype: the
    transfer layer's and the server's host copy. bfloat16 comes out as an
    ml_dtypes ``bfloat16`` array through an int16 view, the reverse of
    :func:`host_to_tensor`, as ``np.asarray`` of a JAX bf16 array does."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(
            numpy_dtype("bfloat16"))
    return t.cpu().numpy()


def tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a host ndarray for a numerical
    comparison: bfloat16 widens to float32 (what the tests compare in).
    The transfer layer keeps the dtype (:func:`tensor_to_numpy`)."""
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


def lm_params_from_reference(params, device) -> dict[str, torch.Tensor]:
    """The JAX package's ``DecoderLM`` or ``EncDecLM`` parameter tree, as
    numpy (e.g. ``jax.tree.map(np.asarray, params)``), as a state dict of
    the port's model on ``device`` (``model.load_state_dict(...)``).

    The map is a rename plus an unstack:

    ==================================  ===============================
    JAX package path                    port parameter
    ==================================  ===============================
    ``embed/embedding``                 ``embed.embedding``
    ``final_norm/scale``                ``final_norm.scale``
    ``lm_head/embedding``               ``lm_head.embedding``
    ``segments/{i}/b{j}/<path>`` [l]    ``layers.{n}.<path>``
    ``encoder/blocks/<path>`` [l]       ``encoder.blocks.{l}.<path>``
    ``encoder/final_norm/<path>``       ``encoder.final_norm.<path>``
    ==================================  ===============================

    where ``<path>`` keeps its names with ``/`` read as ``.`` and layer
    ``n = o_i + l * c_i + j``: segment ``i`` stacks ``count_i`` cycles of
    ``c_i`` blocks (``b0`` .. ``b{c_i - 1}``) along a leading axis indexed
    by ``l``, and ``o_i`` counts the layers of the segments before it
    (DeepSeek-V2's dense first layer is segment 0, its MoE layers segment
    1, so they are layers 1, 2, ...). The paths, by block:

    =====================  ==============================================
    block                  ``<path>`` examples
    =====================  ==============================================
    attention, local       ``norm1/scale``, ``temporal/q/w``,
                           ``temporal/q_norm/scale``, ``ffn/up/w``
    RG-LRU                 ``temporal/lam``, ``temporal/conv_w``
    MLA                    ``temporal/w_dkv/w``, ``temporal/kv_norm/scale``,
                           ``temporal/w_uq/w`` (q-LoRA) or ``temporal/w_q/w``
    MoE FFN                ``ffn/router/w``, ``ffn/gate_w``, ``ffn/up_w``,
                           ``ffn/down_w``, ``ffn/shared/up/w``
    RWKV6 (the whole       ``ln1/scale``, ``r/w``, ``w0``, ``w_a``,
    layer, top level)      ``ln_x_scale``, ``cm_k/w``
    cross-attention        ``norm_x/scale``, ``norm_x/bias``, ``cross/q/w``,
    (enc-dec decoder)      ``cross/k/w`` (encoder width in)
    encoder block          ``norm1/scale``, ``self/q/w``, ``ffn/up/w``
    =====================  =============================================="""
    out: dict[str, torch.Tensor] = {}

    def leaves(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    offset = 0
    for seg in params["segments"]:
        cycle = len(seg)
        count = None
        for j in range(cycle):
            for path, arr in leaves(seg[f"b{j}"], ""):
                arr = np.asarray(arr)
                count = arr.shape[0]
                for lyr in range(count):
                    out[f"layers.{offset + lyr * cycle + j}.{path}"] = \
                        host_to_tensor(arr[lyr], device)
        offset += cycle * count
    for k, v in params.items():
        if k == "encoder":
            for path, arr in leaves(v["blocks"], ""):
                arr = np.asarray(arr)
                for lyr in range(arr.shape[0]):
                    out[f"encoder.blocks.{lyr}.{path}"] = \
                        host_to_tensor(arr[lyr], device)
            v = {"final_norm": v["final_norm"]}
        if k != "segments":
            out.update((path, host_to_tensor(np.asarray(arr), device))
                       for path, arr in leaves(v, f"{k}."))
    return out


def adamw_state_from_reference(opt, device) -> dict:
    """The JAX package's AdamW state of a ``DecoderLM`` (``{"m", "v",
    "step"}``, ``m`` and ``v`` with the parameters' tree structure, as
    numpy) as the port's: ``m`` and ``v`` renamed and unstacked as
    :func:`lm_params_from_reference` does, ``step`` an int."""
    return {"m": lm_params_from_reference(opt["m"], device),
            "v": lm_params_from_reference(opt["v"], device),
            "step": int(np.asarray(opt["step"]))}
