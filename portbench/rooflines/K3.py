"""K3, the background mesh upsample (``csrc/upsample.cu``), through
``ops.upsample.upsample_mesh``.

The meshes and both weight matrices read once, each (H, W) plane
written once; a multiply and an add for each nonzero weight of a band:
the (H, nx) product ``Wy @ mesh``, then every output pixel."""

import torch

from portbench.reference.ops.upsample import weight_bands

WRAPPER = ("ops.upsample", "upsample_mesh")
KERNELS = ("up_kernel", "out_kernel")


def _band_width(w) -> torch.Tensor:
    b = weight_bands(torch.as_tensor(w))
    return (b[:, 1] - b[:, 0] + 1).clamp(min=0).sum()


def record(args: dict, out) -> dict:
    H, W = args["out_shape"]
    ny, nx = args["meshes"][0].shape
    return {"H": H, "W": W, "ny": ny, "nx": nx, "n": len(args["meshes"]),
            "wy": _band_width(args["Wy"]), "wx": _band_width(args["Wx"])}


def work(rec: dict):
    H, W, ny, nx, n = rec["H"], rec["W"], rec["ny"], rec["nx"], rec["n"]
    nbytes = 4.0 * (n * H * W + H * ny + W * nx + n * ny * nx)
    ops = 2.0 * n * (int(rec["wy"]) * nx + int(rec["wx"]) * H)
    return nbytes, ops, 0.0
