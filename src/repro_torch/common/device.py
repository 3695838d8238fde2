"""The one rule every entry point of the port applies to its device."""
from __future__ import annotations

import torch


def explicit_device(device="cuda", who: str = "repro_torch") -> torch.device:
    """``device`` as a ``torch.device``. ``"cuda"`` (the default of every
    entry point) raises when CUDA is absent: nothing falls back to the
    CPU, which runs only when a caller asks for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}): CUDA is not available here; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {dev} (cpu or cuda)")
    return dev
