"""K4, the window gather (``csrc/gather.cu``), through
``ops.windows.gather_slot_windows``.

Each image's windows read for the live slots (``n_active``, or every
slot) and written for every slot, at the image's own element size."""

import torch

WRAPPER = ("ops.windows", "gather_slot_windows")
KERNELS = ("gather_kernel",)


def record(args: dict, out) -> dict:
    images = args["images"]
    imgs = tuple(images) if isinstance(images, (tuple, list)) else (images,)
    return {"N": int(args["y0"].shape[0]), "size": int(args["size"]),
            "itemsize": sum(im.element_size() for im in imgs),
            "live": None if args["n_active"] is None
            else torch.as_tensor(args["n_active"]).clone()}


def work(rec: dict):
    N = rec["N"]
    live = N if rec["live"] is None else min(int(rec["live"]), N)
    return float(rec["itemsize"] * rec["size"] ** 2 * (live + N)), 0.0, 0.0
