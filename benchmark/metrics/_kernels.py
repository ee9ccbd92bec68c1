"""Shared arithmetic of the kernel readers: a kernel's device time in the
window and its share of the least time its launches could take."""

from __future__ import annotations


def dtype_of(trace) -> str:
    """The kernels' float type: float32 at ``x32``, float64 otherwise
    (``x64`` and ``df32`` both run in float64 in the port)."""
    precision = trace.cell.traffic.get("precision", trace.cell.config["physics"]["precision"])
    return "float32" if precision == "x32" else "float64"


def roofline_pct(ops, least_s_per_launch: float):
    """100 x the least time of the launches over their device time; None
    without a launch."""
    busy = sum(o.dur for o in ops) * 1e-6
    if not ops or busy <= 0:
        return None
    return 100.0 * least_s_per_launch * len(ops) / busy
