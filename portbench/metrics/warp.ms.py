"""``warp.ms``: mean device ms a frame of ``warp_shift2pass``, the
reference's planes remapped onto the visit in the science back.

A span as ``calibration.ms`` takes it."""

SPANS = {"warp": (("pipeline.subtract", "warp_shift2pass"),)}


def read(trace):
    return trace.span_mean_ms("warp")
