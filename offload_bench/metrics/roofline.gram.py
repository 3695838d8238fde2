"""Kernels: gram's least time (operations over the TF32 peak or bytes over
HBM, the larger, from each call's shapes) over the device time of
everything launched inside its entry point's calls, in the traced
window."""
from offload_bench import counts

ENTRY = "repro_torch.kernels.gram.ops:gram"


def _count(args):
    a = args[0]
    return counts.gram(*a["shape"], a["itemsize"])


def read(run):
    return run.roofline_pct(ENTRY, _count)
