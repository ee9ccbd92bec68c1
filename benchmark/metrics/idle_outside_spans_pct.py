"""``idle_outside_spans_pct``: the share of card 0's idle time inside the
window's jobs that no span of the port (``psa.``) covers, in %: idle time of
the program that the trace cannot put to a step of it.  The gaps between
jobs (the benchmark's own loop) are left out."""

from benchmark.metrics import _spans


def read(trace):
    found = _spans.idle_outside_spans(trace)
    if found is None or found[0] <= 0:
        return None
    idle, outside = found
    return 100.0 * outside / idle
