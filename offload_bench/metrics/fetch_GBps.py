"""Client and bridge: the rate of the fetch's device-to-host copies, the
bytes of every chunk fetched over the summed seconds of their copies (the
program's ``fetch.copy`` spans), in GB/s, over the traced window. Nothing
where the program records no spans."""


def read(run):
    try:
        from repro_torch.common import spans
    except ImportError:
        return None
    copies = [s for s in spans.snapshot()["spans"] if s.name == "fetch.copy"]
    seconds = sum(s.seconds for s in copies)
    if seconds <= 0:
        return None
    return sum(s.attrs["bytes"] for s in copies) / seconds / 1e9
