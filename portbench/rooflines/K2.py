"""K2, the k x k median (``csrc/medians.cu``), through
``ops.filters.median_filter``: a full frame, or a chunk of L.A.Cosmic's
windows stacked into one plane.

float32 read once and written once; at each pixel the min/max
instructions of the tile program the kernel runs
(``tile_median_ops(k, *MEDIAN_TILE)``, shared over the tile's
outputs), from the reference's copy of the networks."""

from portbench.reference.ops import filters

WRAPPER = ("ops.filters", "median_filter")
KERNELS = ("median_kernel",)

_PER_PX = {}


def per_pixel(k: int) -> float:
    if k not in _PER_PX:
        th, tw = filters.MEDIAN_TILE
        ops, _, _ = filters.tile_median_ops(k, th, tw)
        _PER_PX[k] = filters.comparator_cost(ops) / (th * tw)
    return _PER_PX[k]


def record(args: dict, out) -> dict:
    H, W = args["img"].shape
    return {"H": H, "W": W, "k": int(args["k"])}


def work(rec: dict):
    n = rec["H"] * rec["W"]
    return 8.0 * n, per_pixel(rec["k"]) * n, 0.0
