"""Peak device memory over the window (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats``), in GB: it bounds the rows one card
holds."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 1e9
