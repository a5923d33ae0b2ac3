"""Entry ``reduce``: ``make_reduce_fn(ctx)``, a raw frame to its
calibrated mosaic, mask and PSF catalog.

Its traffic file gives ``field`` (``stars``, ``saturated``, ``flux_e``,
``saturated_flux_e``, ``new_field_each_frame``), ``cosmics`` and
``trail``.
"""

from __future__ import annotations

from portbench import frames
from portbench.package import Inputs, Package


def inputs(config: dict, traffic: dict, seed: int, device,
           pool: int) -> Inputs:
    """``pool`` raw frames and the calibration inputs of one run."""
    scene = frames.scene(config)
    x = Inputs([], *frames.masters(frames.generator(seed, 0, device=device),
                                   scene.geom, config["assumed"]))
    field = None
    if not traffic["field"]["new_field_each_frame"]:
        field = frames.field_stars(frames.generator(seed, 1, device=device),
                                   scene, traffic["field"])
    for i in range(pool):
        gen = frames.generator(seed, 3, i, device=device)
        stars = (frames.field_stars(gen, scene, traffic["field"])
                 if field is None else field)
        x.pool.append(frames.raw_frame(gen, scene, stars, traffic["cosmics"],
                                       traffic["trail"]))
    return x


class Entry:
    """Raw frame -> calibrated image, mask and catalog."""

    def __init__(self, pkg: Package, config, traffic, inputs: Inputs,
                 device):
        self.fn = pkg.reduce.make_reduce_fn(pkg.context(config),
                                            device=device)
        self.inputs = inputs

    def __call__(self, raw) -> dict:
        x = self.inputs
        out = self.fn(*raw, x.mbias, x.mflat, None, x.xtalk)
        return {k: out[k] for k in ("image", "mask", "bkg_std", "cat")}
