"""Hand-written CUDA kernels of the port, one package each (``gram``,
``normal_matvec``, ``rf_map``): ``ref.py`` is the plain PyTorch version,
``<name>.py`` launches the CUDA kernel of ``repro_torch/csrc/<name>.cu``,
and ``ops.py`` is the wrapper callers use — it checks its operands, takes
the plain version for CPU tensors and launches the kernel for CUDA
tensors, counting each launch."""
from __future__ import annotations


def launch_counters() -> dict:
    """name -> LaunchCounter of every kernel wrapper."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.normal_matvec import ops as nm_ops
    from repro_torch.kernels.rf_map import ops as rf_ops
    return {"gram": gram_ops.LAUNCHES, "normal_matvec": nm_ops.LAUNCHES,
            "rf_map": rf_ops.LAUNCHES}
