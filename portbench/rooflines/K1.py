"""K1, label propagation (``csrc/labelprop.cu``: a tile scan, then the
steps on the listed tiles), through ``ops.labeling.label_propagate``.

int32 labels read once and written once; 8 int32 mins a step for each
foreground pixel (a label below the sentinel ``H*W + 2``)."""

WRAPPER = ("ops.labeling", "label_propagate")
KERNELS = ("scan_tiles", "prop_tiles")


def record(args: dict, out) -> dict:
    lab = args["lab"]
    H, W = lab.shape
    return {"H": H, "W": W, "steps": int(args["iters"]),
            "nfg": (lab < H * W + 2).sum()}


def work(rec: dict):
    """(bytes, float32 operations, int32 operations)."""
    H, W = rec["H"], rec["W"]
    return 8.0 * H * W, 0.0, 8.0 * rec["steps"] * int(rec["nfg"])
