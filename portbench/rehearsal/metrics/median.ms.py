"""``median.ms``: mean ms a call of ``stats.median``, the stack's median.

A span as ``calibration.ms`` takes it."""

SPANS = {"median": (("ops.stats", "median"),)}


def read(trace):
    return trace.span_mean_ms("median")
