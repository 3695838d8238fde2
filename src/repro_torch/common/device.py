"""The one rule every entry point of the port applies to its device."""
from __future__ import annotations

import torch


def explicit_device(device="cuda", who: str = "repro_torch",
                    allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``. ``"cuda"`` (the default of every
    entry point) raises when CUDA is absent: nothing falls back to the
    CPU, which runs only when a caller asks for ``"cpu"``. ``"meta"``
    (shapes and dtypes, no data) only where the caller passes
    ``allow_meta``: the model builders and the dry run, never the engine
    or the serve and train launchers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}): CUDA is not available here; "
            "pass device='cpu' to run on the CPU")
    allowed = ("cuda", "cpu", "meta") if allow_meta else ("cuda", "cpu")
    if dev.type not in allowed:
        raise ValueError(f"{who}: unsupported device {dev} "
                         f"({' or '.join(allowed)})")
    return dev
