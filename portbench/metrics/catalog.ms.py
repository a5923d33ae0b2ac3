"""``catalog.ms``: mean device ms a frame of ``extract_catalog``:
background, detection, moments, photometry and the PSF fit.

A span as ``calibration.ms`` takes it."""

SPANS = {"catalog": (("pipeline.reduce", "extract_catalog"),
                     ("pipeline.subtract", "extract_catalog"))}


def read(trace):
    return trace.span_mean_ms("catalog")
