"""K5, fused detection (``csrc/detect.cu``: the filter, threshold and
tile scan, then the label steps on the listed tiles), through
``ops.detection.fused_detect``.

The image, the std map (float32) and the exclusion mask (1 byte) read
once, the int32 segment map written once; the separable filter's
multiply and add for each tap, twice, at every pixel; 8 int32 mins a
step for each detected pixel."""

WRAPPER = ("ops.detection", "fused_detect")
KERNELS = ("detect_scan", "prop_tiles")


def record(args: dict, out) -> dict:
    H, W = args["image"].shape
    taps = args["taps"]
    return {"H": H, "W": W, "std": args["bkg_std"] is not None,
            "excl": args["excl"] is not None,
            "ntaps": 0 if taps is None else len(taps),
            "iters": int(args["iters"]), "nfg": (out[0] > 0).sum()}


def work(rec: dict):
    n = rec["H"] * rec["W"]
    per_px = 8 + 4 * rec["std"] + rec["excl"]
    return (float(per_px * n), 2.0 * 2.0 * rec["ntaps"] * n,
            8.0 * rec["iters"] * int(rec["nfg"]))
