"""Checkpointing: a parameter dict and the AdamW state <-> ``.npz`` with
name-keyed arrays: ``params/<name>``, ``opt/m/<name>``, ``opt/v/<name>``,
``opt/step`` and ``meta/step`` (the JAX package's layout, with the port's
parameter names)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.interop import host_to_tensor, tensor_to_numpy


def _flatten(opt_state: dict) -> dict[str, np.ndarray]:
    flat = {f"{part}/{k}": tensor_to_numpy(t)
            for part in ("m", "v") for k, t in opt_state[part].items()}
    flat["step"] = np.asarray(opt_state["step"], np.int32)
    return flat


def save_checkpoint(path: str, params: dict,
                    opt_state: Optional[dict] = None,
                    step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": tensor_to_numpy(v) for k, v in params.items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    payload["meta/step"] = np.asarray(step)
    np.savez(path, **payload)


def restore_checkpoint(path: str, params_like: dict,
                       opt_like: Optional[dict] = None):
    """Returns (params, opt_state, step): tensors of the dtype, device and
    ``requires_grad`` of their counterparts in ``params_like`` and
    ``opt_like``, which must name what was saved."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def rebuild(prefix: str, like: dict) -> dict:
        out = {}
        for name, t in like.items():
            arr = host_to_tensor(data[f"{prefix}/{name}"], t.device)
            out[name] = arr.to(t.dtype).requires_grad_(t.requires_grad)
        return out

    params = rebuild("params", params_like)
    opt_state = None
    if opt_like is not None:
        opt_state = {"m": rebuild("opt/m", opt_like["m"]),
                     "v": rebuild("opt/v", opt_like["v"]),
                     "step": int(data["opt/step"])}
    step = int(data["meta/step"])
    return params, opt_state, step
