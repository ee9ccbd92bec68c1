"""``k3_accepted_pct``: the share of K3's (``csrc/fwm4_rk45.cu``) attempts
that its controller accepted, in %: the sums of the port's ``psa.count
k3`` marks in the window."""

from benchmark.metrics import _spans


def read(trace):
    if not trace.device_ops:
        return None
    found = _spans.marks(trace, "k3")
    attempts = sum(m["attempts"] for m in found)
    if not attempts:
        return None
    return 100.0 * sum(m["accepted"] for m in found) / attempts
