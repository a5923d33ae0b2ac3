"""``calibration.ms``: mean device ms a frame of ``calibrate_detector``,
the raw frame to the calibrated mosaic and mask (gain, overscan, mask,
L.A.Cosmic, crosstalk, trails, edge fill).

A span of the benchmark's own around each call, where the pipeline
modules look the function up, synchronised at both ends and timed with
CUDA events, summed over the traced window and divided by its frames.
A span that never ran gives no value."""

SPANS = {"calibration": (("pipeline.reduce", "calibrate_detector"),
                         ("pipeline.subtract", "calibrate_detector"))}


def read(trace):
    return trace.span_mean_ms("calibration")
