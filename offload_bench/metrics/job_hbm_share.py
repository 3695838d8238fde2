"""The whole job: the bytes its algorithm must move (``counts.job_bytes``)
over the job time and HBM's bandwidth. Nothing where operations bound the
job."""

from offload_bench import counts


def read(run):
    amount = counts.job_bytes(run.traffic["routine"], run.config, run.args)
    if not amount or not run.job_s:
        return None
    return 100.0 * amount / (run.job_s * counts.PEAKS["hbm_bytes_per_s"])
