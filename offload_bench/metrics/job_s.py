"""Time to result of one offload job: from the first job's start to the
last counted job's end (its factors fetched to the client), over the jobs
completed. No partial job counts."""


def read(run):
    return run.job_s
