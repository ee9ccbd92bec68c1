"""``copy_ms_per_job``: the device time of the copies between host and card
(the inputs in, the summaries out), per job, in ms."""


def read(trace):
    ops = trace.ops(cat=("gpu_memcpy",))
    if not trace.n_jobs or not ops:
        return None
    return 1e3 * sum(o.dur for o in ops) * 1e-6 / trace.n_jobs
