"""``master.gaincf.ms``: mean ms a master of ``pipeline.masters.gaincf``,
a flat's GAINCF: the vertical matching and the horizontal chain (0 in a bias).

A span as ``calibration.ms`` takes it, averaged over every master of the
window."""

SPANS = {"master.gaincf": (("pipeline.masters", "gaincf"),)}


def read(trace):
    return trace.span_mean_ms("master.gaincf")
