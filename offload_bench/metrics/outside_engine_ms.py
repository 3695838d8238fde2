"""Engine and scheduler: milliseconds of a job outside the routine's
execution (the engine's ``_elapsed``) and outside the fetch: submission,
queueing, dispatch, result hand-back and freeing. Mean over the jobs."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j.end - j.start - j.exec_s - j.fetch_s
                     for j in run.jobs) / len(run.jobs)
