"""K7, fused L.A.Cosmic iterations (``csrc/lacosmic.cu``: four launches
an iteration), through ``ops.lacosmic_fused.lacosmic_fused``.

The float32 frame and bool mask read once, the cleaned frame and the
bool cosmic mask written once; each iteration's dense stages at every
pixel (stage 1's 5x5 and stage 2's 3x3 and 5x5 medians as K2's tile
programs, the Laplacian, noise model, ratios, both dilations and their
tests).  The 7x7 medians and cleans of the pixels the kernel lists are
not visible at the wrapper and are left out, so the bound is low and
the share of it a floor."""

from portbench.reference.ops import filters

WRAPPER = ("ops.lacosmic_fused", "lacosmic_fused")
KERNELS = ("stage1", "stage2", "grow_scan", "clean_listed")


def dense_ops() -> float:
    def tile(k):
        ops, _, _ = filters.tile_median_ops(k, *filters.MEDIAN_TILE)
        return filters.comparator_cost(ops) / (filters.MEDIAN_TILE[0]
                                               * filters.MEDIAN_TILE[1])
    rest1 = 24                               # lap 17, noise 2, s 2, clamp
    rest2 = 7                                # sp, gt(sp, sigclip), good, c1
    grow = 9 + 25 + 2 * 7 + 1                # two dilations, gts, max
    return tile(5) + tile(3) + rest1 + tile(5) + rest2 + grow


def record(args: dict, out) -> dict:
    H, W = args["data"].shape
    return {"H": H, "W": W, "niter": int(args["niter"])}


def work(rec: dict):
    n = rec["H"] * rec["W"]
    return 10.0 * n, rec["niter"] * dense_ops() * n, 0.0
