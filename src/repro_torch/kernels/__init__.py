"""Hand-written CUDA kernels of the port, one package each (``gram``,
``normal_matvec``, ``rf_map``, ``swa``, ``lru_scan``): ``ref.py`` is the
plain PyTorch version, ``<name>.py`` launches the CUDA kernel of
``repro_torch/csrc/<name>.cu``, and ``ops.py`` is the wrapper callers
use — it checks its operands, takes the plain version for CPU tensors and
launches the kernel for CUDA tensors, counting each launch. ``swa`` also
holds its backward (``csrc/swa_bwd.cu``) and ``lru_scan`` its reverse
launch, the two halves of their autograd Functions, and ``normal_matvec``
its one-pass route for narrow w (``csrc/normal_matvec_stream.cu``)."""
from __future__ import annotations


def launch_counters() -> dict:
    """name -> LaunchCounter of every kernel wrapper."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.normal_matvec import ops as nm_ops
    from repro_torch.kernels.rf_map import ops as rf_ops
    from repro_torch.kernels.swa import ops as swa_ops
    return {"gram": gram_ops.LAUNCHES, "normal_matvec": nm_ops.LAUNCHES,
            "normal_matvec_stream": nm_ops.STREAM_LAUNCHES,
            "rf_map": rf_ops.LAUNCHES, "swa": swa_ops.LAUNCHES,
            "swa_bwd": swa_ops.BWD_LAUNCHES, "lru_scan": lru_ops.LAUNCHES,
            "lru_scan_reverse": lru_ops.REVERSE_LAUNCHES}
