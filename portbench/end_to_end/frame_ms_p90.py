"""``frame_ms_p90``: the 90th percentile of every frame's latency in the
window, from the entry's call to its ``torch.cuda.synchronize()`` (host
clock), by ``statistics.quantiles`` (inclusive)."""

import statistics


def read(window):
    ms = [x * 1e3 for x in window.latency_s]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
