"""``device_ops_per_job``: the kernels, copies and memsets the card ran in
the window, over every card, per job: a count that repeats exactly while
the API and its parameter math issue the same work."""


def read(trace):
    if not trace.n_jobs or not trace.device_ops:
        return None
    return len(trace.device_ops) / trace.n_jobs
