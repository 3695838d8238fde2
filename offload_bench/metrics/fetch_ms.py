"""Client and bridge: host milliseconds a job spends fetching its outputs
to the client (``to_numpy``), the mean over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j.fetch_s for j in run.jobs) / len(run.jobs)
