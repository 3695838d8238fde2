"""The whole job: milliseconds a job's routine spends on host work while
it has nothing queued on the card (the program's ``rf.weights``,
``lanczos.reorth`` and ``lanczos.ritz`` spans), summed over each job, the
mean over the traced window's jobs. Nothing where the program records no
such span."""

HOST = ("rf.weights", "lanczos.reorth", "lanczos.ritz")


def read(run):
    try:
        from repro_torch.common import spans
    except ImportError:
        return None
    recorded = spans.snapshot()["spans"]
    jobs = {s.job for s in recorded if s.name == "engine.execute"}
    host = [s.seconds for s in recorded if s.name in HOST and s.job in jobs]
    if not jobs or not host:
        return None
    return 1e3 * sum(host) / len(jobs)
