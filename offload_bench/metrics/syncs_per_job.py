"""The whole job: how often a job's routine waits on the device from the
host (the program's ``syncs`` counter: CG's residual each iteration and
at the start, a Lanczos step's copy of X^T X q), the mean over the traced
window's jobs. Nothing where the program keeps no such counter."""


def read(run):
    try:
        from repro_torch.common import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    jobs = {s.job for s in snap["spans"] if s.name == "engine.execute"}
    syncs = [snap["counters"].get(j, {}).get("syncs") for j in jobs]
    if not jobs or all(n is None for n in syncs):
        return None
    return sum(n or 0 for n in syncs) / len(jobs)
