"""``k3_attempts_per_lane``: K3's (``csrc/fwm4_rk45.cu``) adaptive attempts,
accepted and rejected, per lane: the sums of the port's ``psa.count k3``
marks in the window (one a launch), attempts over lanes."""

from benchmark.metrics import _spans


def read(trace):
    if not trace.device_ops:
        return None
    found = _spans.marks(trace, "k3")
    lanes = sum(m["lanes"] for m in found)
    if not lanes:
        return None
    return sum(m["attempts"] for m in found) / lanes
