"""``shard_spread_ms``: how far apart the cards finish a job's comb kernels
(K4, ``csrc/comb_rk.cu``): in each job, the last card's K4 end minus the
first card's, in ms, averaged over the jobs in which every card ran one."""

KERNEL = "comb_rk_kernel"


def read(trace):
    ops = trace.ops(cat=("kernel",), name_has=KERNEL)
    chips = trace.cell.chips
    if chips < 2 or not ops:
        return None
    spreads = []
    k = 0
    for start, end in trace.jobs:
        ends = {}
        while k < len(ops) and ops[k].start < start:
            k += 1
        j = k
        while j < len(ops) and ops[j].start <= end:
            ends[ops[j].device] = max(ends.get(ops[j].device, 0.0), ops[j].end)
            j += 1
        if len(ends) == chips:
            spreads.append(max(ends.values()) - min(ends.values()))
    if not spreads:
        return None
    return 1e-3 * sum(spreads) / len(spreads)
