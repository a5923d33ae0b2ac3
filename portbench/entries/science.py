"""Entry ``science``: ``make_science_programs(ctx, xtalk,
remap_ranges=..., remap_step=...)``, ``front`` then ``back`` a visit,
against a reference frame of the same field that the side itself
reduced in set-up.

Its traffic file gives what ``reduce``'s does, and ``transients``
(``count``, ``flux_e``, ``edge_px``: new sources in each visit) and
``reference`` (``depth``, the registration's ``rotation_deg`` and
``offset_px``, ``remap_step``, ``remap_strips``).
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import frames
from portbench.package import Inputs, Package


@dataclasses.dataclass
class VisitInputs(Inputs):
    ref_raw: tuple = None       # the reference frame's raw stacks
    grid: tuple = None          # (sy, sx) coarse remap grid
    to_visit: object = None     # reference (x, y) -> visit


def inputs(config: dict, traffic: dict, seed: int, device,
           pool: int) -> VisitInputs:
    """``pool`` visits of one field, its reference frame and the
    registration between them."""
    scene = frames.scene(config)
    H, W = scene.geom.red_shape
    x = VisitInputs([], *frames.masters(
        frames.generator(seed, 0, device=device), scene.geom,
        config["assumed"]))
    field = frames.field_stars(frames.generator(seed, 1, device=device),
                               scene, traffic["field"])
    r = traffic["reference"]
    sy, sx, x.to_visit = frames.registration(
        (H, W), r["rotation_deg"], r["offset_px"], r["remap_step"])
    x.grid = (sy, sx)
    x.ref_raw = frames.raw_frame(frames.generator(seed, 2, device=device),
                                 scene, field, traffic["cosmics"],
                                 traffic["trail"])
    t = traffic["transients"]
    edge = min(t["edge_px"], H // 6)
    for i in range(pool):
        gen = frames.generator(seed, 3, i, device=device)
        xs, ys, flux = field
        xs, ys = x.to_visit(xs, ys)
        tx = edge + (W - 2 * edge) * torch.rand(
            t["count"], generator=gen, device=gen.device)
        ty = edge + (H - 2 * edge) * torch.rand(
            t["count"], generator=gen, device=gen.device)
        stars = (torch.cat([xs, tx]), torch.cat([ys, ty]),
                 torch.cat([flux, torch.full_like(tx, t["flux_e"])]))
        x.pool.append(frames.raw_frame(gen, scene, stars, traffic["cosmics"],
                                       traffic["trail"]))
    return x


class Entry:
    """Raw visit -> calibrated frame, catalog, difference maps and
    transient catalog, against the reference frame made ``depth`` times
    deeper."""

    def __init__(self, pkg: Package, config, traffic, inputs: VisitInputs,
                 device):
        ctx = pkg.context(config)
        r = traffic["reference"]
        depth = float(r["depth"])
        front, _ = pkg.subtract.make_science_programs(
            ctx, inputs.xtalk, device=device)
        f = front(*inputs.ref_raw, inputs.mbias, inputs.mflat, None)
        cat = f["cat"]
        vx, vy = inputs.to_visit(cat["x"], cat["y"])
        self.ref = (f["sub"] * depth, f["bkg_std"] * depth, f["mask"],
                    inputs.grid, f["psf_centre"],
                    pkg.stats.median(f["bkg_std"]) * depth,
                    {"x": vx, "y": vy, "flux": cat["flux_psf"] * depth,
                     "fluxerr": cat["fluxerr_psf"] * depth,
                     "valid": cat["valid"]})
        del f, cat
        sy, sx = inputs.grid
        ranges = pkg.warp.grid_shift_ranges(sy, sx, step=r["remap_step"],
                                            blocks=r["remap_strips"])
        self.front, self.back = pkg.subtract.make_science_programs(
            ctx, inputs.xtalk, remap_ranges=ranges,
            remap_step=r["remap_step"], device=device)
        self.inputs = inputs

    def __call__(self, raw) -> dict:
        x = self.inputs
        f = self.front(*raw, x.mbias, x.mflat, None)
        ref_sub, ref_std, ref_mask, grid, psf_ref, sr, ref_cat = self.ref
        b = self.back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                      f["cat"], f["stats"]["bkg_std"], ref_sub, ref_std,
                      ref_mask, grid, psf_ref, sr, ref_cat)
        return {"image": f["sub"], "mask": f["mask"],
                "bkg_std": f["bkg_std"], "cat": f["cat"], "D": b["D"],
                "Scorr": b["Scorr"], "Fpsf": b["Fpsf"],
                "trans_cat": b["trans_cat"]}
