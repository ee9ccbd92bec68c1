"""``launch_ms_per_job``: the host's time in the kernels' wrappers a job, in
ms: the self time of the port's ``psa.k<N>.launch`` spans (the layout into
the kernel's rows, its buffers, the launch and what the wrapper queues
after it), or of ``psa.k<N>.plain`` where a call takes the kernel's plain
torch version (``engine='torch'``)."""

from benchmark.metrics import _spans


def read(trace):
    return _spans.per_job_ms(trace, _spans.LAUNCH.fullmatch)
