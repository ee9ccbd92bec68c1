"""``k4_roofline_pct``: K4's (``csrc/comb_rk.cu``) least time over its device
time, in %, summed over the cards.  The least time of a launch is the
larger of its operations (combs x steps x the frozen comb step count, the
cubic sum as two FFTs, plus the saves) at the card's peak and its bytes at
the memory rate (``benchmark/reference/counts``)."""

from benchmark.metrics._kernels import dtype_of, roofline_pct
from benchmark.reference import counts

KERNEL = "comb_rk_kernel"


def read(trace):
    ops = trace.ops(cat=("kernel",), name_has=KERNEL)
    if not ops:
        return None
    ph = trace.cell.config["physics"]
    dtype = dtype_of(trace)
    combs = trace.cell.instances_per_job // trace.cell.chips
    flop, nbytes = counts.comb_rk_work(combs, int(ph["n_lines"]), int(ph["n_steps"]),
                                       int(ph["save_every"]), dtype)
    return roofline_pct(ops, counts.least_seconds(flop, nbytes, dtype))
