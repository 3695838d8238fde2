"""The whole job: the operations its algorithm needs (``counts.job_ops``)
over the job time and the TF32 tensor-core peak. Nothing where bytes, not
operations, bound the job."""

from offload_bench import counts


def read(run):
    amount = counts.job_ops(run.traffic["routine"], run.config, run.args)
    if not amount or not run.job_s:
        return None
    return 100.0 * amount / (run.job_s * counts.PEAKS["tf32_flops_per_s"])
