"""``device.idle_pct``: the share of the profiled frames' wall time in
which nothing ran on the card, in %.

1 - the union of the device's kernel, copy and memset intervals over
the time from the first profiled frame's start to the last one's end
(``torch.profiler``, no span synchronising).  No device activity in
the trace gives no value."""


def read(trace):
    dt = trace.device
    if dt is None or dt.busy_s <= 0 or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
