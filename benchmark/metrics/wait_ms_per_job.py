"""``wait_ms_per_job``: the time the host is blocked on the card a job, in
ms: the port's ``psa.wait`` spans, an explicit wait for every card's stream
before the first fetch that the port makes only under a profiler."""

from benchmark.metrics import _spans


def read(trace):
    return _spans.per_job_ms(trace, _spans.named(*_spans.WAIT))
