"""``lacosmic.ms``: mean device ms a frame of L.A.Cosmic as
``calibrate_detector`` calls it (the windowed rounds by default).

A span as ``calibration.ms`` takes it, inside that one."""

SPANS = {"lacosmic": (("pipeline.reduce", "lacosmic"),)}


def read(trace):
    return trace.span_mean_ms("lacosmic")
