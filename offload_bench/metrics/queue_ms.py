"""Engine and scheduler: milliseconds a job waits in the scheduler's
queue, from submit until a worker takes it (the program's
``engine.queue`` spans), the mean over the traced window's jobs. Nothing
where the program records no spans."""


def read(run):
    try:
        from repro_torch.common import spans
    except ImportError:
        return None
    waits = [s.seconds for s in spans.snapshot()["spans"]
             if s.name == "engine.queue"]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
