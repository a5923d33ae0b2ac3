"""``master.median.ms``: mean ms a master of ``pipeline.masters.stack_median``,
the median over the frames' axis (bias, flat and dark alike).

A span as ``calibration.ms`` takes it, averaged over every master of the
window."""

SPANS = {"master.median": (("pipeline.masters", "stack_median"),)}


def read(trace):
    return trace.span_mean_ms("master.median")
