"""Kernels: rf_map's least time (operations over the TF32 peak or bytes
over HBM, the larger, from each call's shapes) over the device time of
everything launched inside its entry point's calls (the weights' copy to
the card included), in the traced window."""
from offload_bench import counts

ENTRY = "repro_torch.kernels.rf_map.ops:rf_map"


def _count(args):
    x, rf_dim = args[0], args[1]
    return counts.rf_map(*x["shape"], int(rf_dim), x["itemsize"])


def read(run):
    return run.roofline_pct(ENTRY, _count)
