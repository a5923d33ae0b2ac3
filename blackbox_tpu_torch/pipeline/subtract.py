"""The science frame: raw channel stacks -> calibrated new frame ->
remapped reference -> ZOGY -> vetted transient catalog (port of the
device half of :mod:`blackbox_tpu.pipeline.subtract`).

:func:`make_science_programs` returns the two halves the JAX package
runs as two device programs: ``front`` (calibration, extraction, PSF
fit, the new frame's PSF stamp) and ``back`` (flux-ratio match, remap,
ZOGY, transients).  Here both run eagerly on the card; the frame never
leaves it between them.  :func:`fused_science_step` is the same flow
as one call.  Not in this port yet: ``SubtractionInput``,
``_measure_scaling`` and ``run_subtraction`` (host WCS and catalog
matching), and the gather-resampler fallback of the remap
(``remap_ranges=None``).
"""

from __future__ import annotations

import dataclasses

import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.ops.psf import psf_at
from blackbox_tpu_torch.ops.stats import nanmedian, nanmean, nanstd
from blackbox_tpu_torch.ops.transients import (TransientParams,
                                               extract_transients,
                                               transient_stats)
from blackbox_tpu_torch.ops.warp import warp_shift2pass
from blackbox_tpu_torch.ops.zogy import ZogyParams, zogy_subtract
from blackbox_tpu_torch.pipeline.reduce import (calibrate_detector,
                                                extract_catalog, to_device)


def measure_scaling_device(new_x, new_y, new_flux, new_fluxerr, new_valid,
                           ref_x, ref_y, ref_flux, ref_fluxerr, ref_valid,
                           radius: float = 3.0, snr_min: float = 10.0,
                           k: int = 512):
    """Flux ratio + astrometric rms on the device from two padded
    catalogs: the brightest ``k`` valid stars of each are matched by
    nearest neighbour on the NEW pixel grid (``ref_x/ref_y`` already
    mapped), and the clipped median of the PSF-flux ratios and the rms
    of the matched offsets come out as 0-d tensors.

    Returns (fratio, fratio_std, dx_rms, dy_rms, nmatch), or
    (1.0, 0.0, 0.5, 0.5, nmatch) when fewer than 3 stars match.
    """
    def select(x, y, f, fe, v):
        snr = f / torch.clamp(fe, min=1e-9)
        ok = v & (f > 0) & (snr > snr_min)
        score = torch.where(ok, f, -torch.inf)
        kk = min(k, int(f.shape[0]))
        # the -inf filler slots tie, and torch and JAX may order them
        # differently; their slots are masked by nok/rok below, so the
        # order among them does not reach the result
        sv, idx = torch.topk(score, kk)
        return x[idx], y[idx], f[idx], torch.isfinite(sv)

    nx, ny, nf, nok = select(new_x, new_y, new_flux, new_fluxerr,
                             new_valid)
    rx, ry, rf, rok = select(ref_x, ref_y, ref_flux, ref_fluxerr,
                             ref_valid)

    d2 = ((nx[:, None] - rx[None, :]) ** 2
          + (ny[:, None] - ry[None, :]) ** 2)
    d2 = torch.where(nok[:, None] & rok[None, :], d2, torch.inf)
    mind2, j = torch.min(d2, dim=1)
    matched = mind2 < radius ** 2

    nan = float("nan")
    r = torch.where(matched, rf[j] / torch.clamp(nf, min=1e-9), nan)
    med = nanmedian(r)
    mad = 1.4826 * nanmedian(torch.abs(r - med)) + 1e-9
    keep = matched & (torch.abs(r - med) < 3 * mad)
    rk = torch.where(keep, r, nan)
    fratio = torch.nan_to_num(nanmedian(rk), nan=1.0)
    fstd = torch.nan_to_num(nanstd(rk), nan=0.0)

    dx = torch.where(keep, nx - rx[j], nan)
    dy = torch.where(keep, ny - ry[j], nan)

    def rms(d):
        c = d - nanmedian(d)
        return torch.sqrt(torch.nan_to_num(nanmean(c ** 2))) + 1e-3

    nmatch = torch.sum(keep, dtype=torch.int32)
    enough = nmatch >= 3
    fratio = torch.where(enough, fratio, 1.0)
    fstd = torch.where(enough, fstd, 0.0)
    dx_rms = torch.where(enough, rms(dx), 0.5)
    dy_rms = torch.where(enough, rms(dy), 0.5)
    return fratio, fstd, dx_rms, dy_rms, nmatch


def _science_front(ctx, chan_data, os_vert, os_hori, mbias, mflat, bpm,
                   xtalk_coeffs):
    """Calibrate + extract + PSF stamp: the pre-FFT half of the science
    step."""
    if not ctx.fit_psf:
        raise ValueError("the science step needs ctx.fit_psf: the "
                         "new-frame PSF stamp and PSF fluxes feed the "
                         "flux-ratio match and the ZOGY kernels")
    sci, mask_m, stats = calibrate_detector(
        ctx, chan_data, os_vert, os_hori, mbias, mflat, bpm, xtalk_coeffs)
    ext = extract_catalog(ctx, sci, mask_m)
    H, W = sci.shape
    return {"image": sci, "mask": mask_m,
            "stats": {**stats, **ext["stats"]},
            "cat": ext["cat"], "bkg": ext["bkg"],
            "bkg_std": ext["bkg_std"], "psf": ext["psf"],
            "seg_nsources": ext["seg_nsources"],
            "sub": sci - ext["bkg"],
            "psf_centre": psf_at(ext["psf"], 0.5 * W, 0.5 * H)}


def _science_back(sub, bstd, mask_m, psf_n, cat, sn,
                  ref_sub, ref_std, ref_mask, grid, psf_ref, sr,
                  ref_cat, zogy_params, trans_params, remap_ranges=None,
                  remap_step: int | None = None):
    """Scaling match + remap + ZOGY + transient extraction: the FFT half
    of the science step.  The JAX package's gather fallback for
    ``remap_ranges=None`` (and its ``remap_margin``) is not ported."""
    fratio, fstd, dx_rms, dy_rms, nmatch = measure_scaling_device(
        cat["x"], cat["y"], cat["flux_psf"], cat["fluxerr_psf"],
        cat["valid"], ref_cat["x"], ref_cat["y"], ref_cat["flux"],
        ref_cat["fluxerr"], ref_cat["valid"])

    # remap the three ref planes in one pass of the two-pass
    # variable-shift Lanczos (nearest for the STD map and the mask)
    srcs3 = (ref_sub, ref_std, ref_mask)
    modes3 = ("lanczos", "nearest", "nearest")
    fills3 = (0.0, sr, maskbits.EDGE)
    if remap_ranges is None:
        raise NotImplementedError(
            "the gather remap (remap_ranges=None) is not ported: pass "
            "remap_ranges from ops.warp.grid_shift_ranges")
    if remap_step is not None and len(grid) == 2:
        grid = (grid[0], grid[1], int(remap_step))
    ref_sub_r, ref_std_r, ref_mask_r = warp_shift2pass(
        srcs3, modes3, fills3, grid, remap_ranges)

    # the measured dx/dy ride the params dataclass into the
    # astrometric-variance term
    zp = dataclasses.replace(zogy_params, dx=dx_rms, dy=dy_rms)
    out = zogy_subtract(sub, ref_sub_r, psf_n, psf_ref, sn, sr, fn=1.0,
                        fr=fratio, var_bkg_new=bstd ** 2,
                        var_bkg_ref=ref_std_r ** 2, params=zp,
                        want_psf_d=False)
    tcat, ntrans = extract_transients(out, mask_m, ref_mask_r, trans_params)

    tstats = transient_stats(tcat, ntrans)
    tstats.update({"z_fratio": fratio, "z_fratio_std": fstd,
                   "z_dxrms": dx_rms, "z_dyrms": dy_rms,
                   "z_nmatch": nmatch, "z_fd": out["F_D"]})
    return {"D": out["D"], "Scorr": out["Scorr"], "Fpsf": out["Fpsf"],
            "Fpsferr": out["Fpsferr"],
            "trans_cat": tcat, "trans_stats": tstats}


def fused_science_step(ctx, chan_data, os_vert, os_hori, mbias, mflat,
                       bpm, xtalk_coeffs, ref_sub, ref_std, ref_mask, grid,
                       psf_ref, sr, ref_cat: dict,
                       zogy_params: ZogyParams = ZogyParams(),
                       trans_params: TransientParams = TransientParams(),
                       remap_ranges=None, remap_step: int | None = None,
                       device="cuda"):
    """Raw channel stacks -> transient catalog in one call: the front
    half, then the back half (arguments as :func:`make_science_programs`'
    two callables take them).  Every array argument moves to ``device``
    (the card unless the caller asks for another)."""
    front, back = make_science_programs(
        ctx, xtalk_coeffs, zogy_params, trans_params,
        remap_ranges=remap_ranges, remap_step=remap_step, device=device)
    f = front(chan_data, os_vert, os_hori, mbias, mflat, bpm)
    b = back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"], f["cat"],
             f["stats"]["bkg_std"], ref_sub, ref_std, ref_mask, grid,
             psf_ref, sr, ref_cat)
    out = {k: v for k, v in f.items() if k not in ("sub", "psf_centre")}
    out.update(b)
    return out


def make_science_programs(ctx, xtalk_coeffs=None,
                          zogy_params: ZogyParams = ZogyParams(),
                          trans_params: TransientParams = TransientParams(),
                          donate: bool = True, remap_ranges=None,
                          remap_step: int | None = None, device="cuda"):
    """The raw -> transient path as two callables run back to back.

    Returns (front, back):
      front(chan, osv, osh, mbias, mflat, bpm) -> dict incl. sub/cat/...
      back(sub, bkg_std, mask, psf_centre, cat, sn, ref_sub, ref_std,
           ref_mask, grid, psf_ref, sr, ref_cat) -> dict (D, Scorr,
           Fpsf, Fpsferr, trans_cat, trans_stats)

    Every array argument (numpy or tensor, in dicts and tuples too)
    moves to ``device``, the card unless the caller asks for another
    (e.g. ``device="cpu"``).  ``donate`` is accepted for the JAX
    signature and has no effect: eager PyTorch frees each intermediate
    when its last reference goes, with nothing to hand over.
    """
    dev = torch.device(device)
    xtalk = to_device(xtalk_coeffs, dev)

    @torch.inference_mode()
    def front(chan, osv, osh, mbias, mflat, bpm):
        return _science_front(ctx, *to_device(
            (chan, osv, osh, mbias, mflat, bpm), dev), xtalk)

    @torch.inference_mode()
    def back(sub, bstd, mask_m, psf_n, cat, sn, ref_sub, ref_std,
             ref_mask, grid, psf_ref, sr, ref_cat):
        args = to_device((sub, bstd, mask_m, psf_n, cat, sn, ref_sub,
                          ref_std, ref_mask, grid, psf_ref, sr, ref_cat),
                         dev)
        return _science_back(*args, zogy_params, trans_params,
                             remap_ranges, remap_step)

    return front, back
