"""``device_idle_pct``: the share of the window in which no kernel, copy or
memset ran on the card, averaged over the cell's cards."""


def read(trace):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
