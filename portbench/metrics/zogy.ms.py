"""``zogy.ms``: mean device ms a frame of ``zogy_subtract``, the ZOGY
difference image, its significance and its flux maps.

A span as ``calibration.ms`` takes it."""

SPANS = {"zogy": (("pipeline.subtract", "zogy_subtract"),)}


def read(trace):
    return trace.span_mean_ms("zogy")
