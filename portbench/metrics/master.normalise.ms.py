"""``master.normalise.ms``: mean ms a master of ``pipeline.masters.normalise``,
a flat's normalisation: the per-frame section medians and the division (0 in a bias).

A span as ``calibration.ms`` takes it, averaged over every master of the
window."""

SPANS = {"master.normalise": (("pipeline.masters", "normalise"),)}


def read(trace):
    return trace.span_mean_ms("master.normalise")
