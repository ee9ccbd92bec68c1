"""``step_mfu``: the whole job's share of the cards' peak, in %: the least
operations of every comb the window's jobs completed (the frozen comb step
count, the cubic sum as two FFTs, plus the saves), over the window's length
times the peak rate of the cell's float type times its cards.  It counts
the jobs, not a kernel's launches, so it reads the same whatever kernels
run the steps (``benchmark/reference/counts``).  None without a device
operation in the window (a run off the card)."""

from benchmark.metrics._kernels import dtype_of
from benchmark.reference import counts


def read(trace):
    ph = trace.cell.config["physics"]
    if "n_lines" not in ph or not trace.device_ops or not trace.n_jobs:
        return None
    dtype = dtype_of(trace)
    flop, _bytes = counts.comb_rk_work(trace.n_jobs * trace.cell.instances_per_job,
                                       int(ph["n_lines"]), int(ph["n_steps"]),
                                       int(ph["save_every"]), dtype)
    return 100.0 * flop / (trace.window_s * counts.PEAK_FLOPS[dtype] * trace.cell.chips)
