"""``inputs_ms_per_job``: the host's time in the API and its parameter math a
job, in ms: the self time of the port's entry spans (``psa.sweep.spectrum``,
``psa.solve_comb_batch``, ``psa.make_comb_coeffs``) and of its plan and
input spans (``psa.sweep.plan``, ``psa.sweep.inputs``, ``psa.nwave.inputs``)."""

from benchmark.metrics import _spans


def read(trace):
    return _spans.per_job_ms(trace, _spans.named(*_spans.INPUTS))
