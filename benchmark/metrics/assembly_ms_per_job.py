"""``assembly_ms_per_job``: the host's time assembling a job's results, in
ms: the self time of the port's ``psa.fetch`` (a copy of results to host
arrays) and ``psa.sweep.gain`` (powers and gains from them) spans."""

from benchmark.metrics import _spans


def read(trace):
    return _spans.per_job_ms(trace, _spans.named(*_spans.ASSEMBLY))
