"""Kernels: normal_matvec's least time (operations over the TF32 peak or
bytes over HBM, the larger, from each call's shapes) over the device time
of everything launched inside its entry point's calls, in the traced
window."""
from offload_bench import counts

ENTRY = "repro_torch.kernels.normal_matvec.ops:normal_matvec"


def _count(args):
    x, w = args[0], args[1]
    return counts.normal_matvec(*x["shape"], w["shape"][1], x["itemsize"])


def read(run):
    return run.roofline_pct(ENTRY, _count)
