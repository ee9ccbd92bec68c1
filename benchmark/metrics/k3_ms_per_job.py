"""``k3_ms_per_job``: K3's (``csrc/fwm4_rk45.cu``) device time per job, in
ms.  A time and not a roofline share: K3's work depends on its attempts,
which only the program counts."""

KERNEL = "fwm4_rk45_kernel"


def read(trace):
    ops = trace.ops(cat=("kernel",), name_has=KERNEL)
    if not trace.n_jobs or not ops:
        return None
    return 1e3 * sum(o.dur for o in ops) * 1e-6 / trace.n_jobs
