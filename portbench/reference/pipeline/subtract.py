"""The science frame: raw channel stacks -> calibrated new frame ->
remapped reference -> ZOGY -> vetted transient catalog (port of
:mod:`blackbox_tpu.pipeline.subtract`).

:func:`make_science_programs` returns the two halves the JAX package
runs as two device programs: ``front`` (calibration, extraction, PSF
fit, the new frame's PSF stamp) and ``back`` (flux-ratio match, remap,
ZOGY, transients).  Here both run eagerly on the card; the frame never
leaves it between them.  :func:`fused_science_step` is the same flow
as one call.  :func:`run_subtraction` is the driver's form: a reduced
new frame against a reference read from disk, each a
:class:`SubtractionInput` of device tensors and host WCS and catalogs;
the flux-ratio match and the choice of remap (the two-pass shifted
adds for survey registrations, the exact row-blocked gathers for wilder
mappings) run on the host, the remap, ZOGY and the transients on the
tensors' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.astro.photcal import match_catalogs
from portbench.reference.core import maskbits
from portbench.reference.ops.psf import PSFModel, psf_at
from portbench.reference.ops.stats import median, nanmedian, nanmean, nanstd
from portbench.reference.ops.transients import (TransientParams,
                                               extract_transients,
                                               transient_stats)
from portbench.reference.ops.warp import (grid_row_margin, grid_shift_ranges,
                                         remap_grid, remap_grid_coarse,
                                         resample_blocked, warp_shift2pass)
from portbench.reference.ops.zogy import ZogyParams, zogy_subtract
from portbench.reference.pipeline.reduce import (calibrate_detector,
                                                extract_catalog, to_device)


@dataclasses.dataclass
class SubtractionInput:
    """One side (new or ref) of a subtraction: device tensors + host
    meta."""

    image: torch.Tensor                 # (H, W) calibrated, NOT bkg-subbed
    bkg: torch.Tensor                   # (H, W) background model
    bkg_std: torch.Tensor               # (H, W)
    mask: torch.Tensor                  # (H, W) uint8
    psf: PSFModel
    wcs: object                         # TanWCS
    cat_x: np.ndarray                   # host catalogs for fratio/dx/dy
    cat_y: np.ndarray
    cat_flux: np.ndarray                # PSF fluxes [e-]
    cat_fluxerr: np.ndarray
    cat_valid: np.ndarray


def _measure_scaling(new: SubtractionInput, ref: SubtractionInput,
                     snr_min: float = 10.0):
    """Flux ratio fr (= F_ref/F_new per unit source) + astrometric rms.

    The reference does this inside zogy via ``get_fratio`` on PSFEx
    stars (consumed in buildref.py:2782-3014); here the already-measured
    PSF-flux catalogs are matched through the WCS pair.
    """
    # ref catalog positions -> new frame
    ra, dec = ref.wcs.pix2sky(ref.cat_x, ref.cat_y)
    rx, ry = new.wcs.sky2pix(ra, dec)

    ok_n = new.cat_valid & (new.cat_flux > 0) \
        & (new.cat_flux > snr_min * np.maximum(new.cat_fluxerr, 1e-9))
    ok_r = ref.cat_valid & (ref.cat_flux > 0) \
        & (ref.cat_flux > snr_min * np.maximum(ref.cat_fluxerr, 1e-9))
    i_n = np.flatnonzero(ok_n)
    i_r = np.flatnonzero(ok_r)
    if len(i_n) == 0 or len(i_r) == 0:
        return 1.0, 0.0, 0.5, 0.5, 0

    mi, mj = match_catalogs(new.cat_x[i_n], new.cat_y[i_n],
                            rx[i_r], ry[i_r], radius_pix=3.0)
    if len(mi) < 3:
        return 1.0, 0.0, 0.5, 0.5, len(mi)
    fn = new.cat_flux[i_n][mi]
    fr = ref.cat_flux[i_r][mj]
    r = fr / np.maximum(fn, 1e-9)
    med = np.median(r)
    mad = 1.4826 * np.median(np.abs(r - med)) + 1e-9
    keep = np.abs(r - med) < 3 * mad
    fratio = float(np.median(r[keep])) if keep.any() else float(med)
    fstd = float(np.std(r[keep])) if keep.any() else 0.0

    dx = new.cat_x[i_n][mi] - rx[i_r][mj]
    dy = new.cat_y[i_n][mi] - ry[i_r][mj]
    dx_rms = float(np.sqrt(np.mean((dx - np.median(dx)) ** 2)) + 1e-3)
    dy_rms = float(np.sqrt(np.mean((dy - np.median(dy)) ** 2)) + 1e-3)
    return fratio, fstd, dx_rms, dy_rms, int(keep.sum())


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
                  ref_cat, zogy_params, trans_params, remap_margin: int = 64,
                  remap_ranges=None, remap_step: int | None = None):
    """Scaling match + remap + ZOGY + transient extraction: the FFT half
    of the science step."""
    fratio, fstd, dx_rms, dy_rms, nmatch = measure_scaling_device(
        cat["x"], cat["y"], cat["flux_psf"], cat["fluxerr_psf"],
        cat["valid"], ref_cat["x"], ref_cat["y"], ref_cat["flux"],
        ref_cat["fluxerr"], ref_cat["valid"])

    # remap the three ref planes in one pass: the two-pass variable-shift
    # Lanczos when the caller gives the shift ranges (remap_ranges from
    # ops.warp.grid_shift_ranges), else the exact row-blocked gathers
    srcs3 = (ref_sub, ref_std, ref_mask)
    modes3 = ("lanczos", "nearest", "nearest")
    fills3 = (0.0, sr, maskbits.EDGE)
    if remap_ranges is not None:
        if remap_step is not None and len(grid) == 2:
            grid = (grid[0], grid[1], int(remap_step))
        ref_sub_r, ref_std_r, ref_mask_r = warp_shift2pass(
            srcs3, modes3, fills3, grid, remap_ranges)
    else:
        if len(grid) == 3:
            raise ValueError("the (sy, sx, step) grid form needs "
                             "remap_ranges (the shift2pass path)")
        H = ref_sub.shape[0]
        block = next(b for b in (1320, 660, 264, 132, 60, 22, 11, 8,
                                 4, 2, 1) if H % b == 0)
        ref_sub_r, ref_std_r, ref_mask_r = resample_blocked(
            srcs3, modes3, fills3, grid, block_rows=block,
            margin=remap_margin)

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
                       remap_margin: int = 64, remap_ranges=None,
                       remap_step: int | None = None, device="cuda"):
    """Raw channel stacks -> transient catalog in one call: the front
    half, then the back half (arguments as :func:`make_science_programs`'
    two callables take them).  Every array argument moves to ``device``
    (the card unless the caller asks for another)."""
    front, back = make_science_programs(
        ctx, xtalk_coeffs, zogy_params, trans_params,
        remap_margin=remap_margin, remap_ranges=remap_ranges,
        remap_step=remap_step, device=device)
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
                          donate: bool = True, remap_margin: int = 64,
                          remap_ranges=None, remap_step: int | None = None,
                          device="cuda"):
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
                             remap_margin, remap_ranges, remap_step)

    return front, back


@dataclasses.dataclass
class SubtractionResult:
    D: torch.Tensor
    Scorr: torch.Tensor
    Fpsf: torch.Tensor
    Fpsferr: torch.Tensor
    trans_cat: dict
    stats: dict
    ref_remapped: torch.Tensor = None   # bkg-subtracted ref on new grid


@torch.inference_mode()
def run_subtraction(new: SubtractionInput, ref: SubtractionInput,
                    zogy_params: ZogyParams = ZogyParams(),
                    trans_params: TransientParams = TransientParams()
                    ) -> SubtractionResult:
    """Full new-vs-ref subtraction on the new frame's grid, on the
    device of ``new.image`` (both sides' tensors must lie there).

    The ref remap picks its kernel from the mapping itself (host-side,
    from the coarse WCS grid): survey registrations (few-px shifts,
    arcmin rotations) take the streaming two-pass variable-shift
    Lanczos (``warp_shift2pass``); wilder mappings take the exact
    slab-blocked gather form (``resample_blocked``), as the JAX package
    decides.
    """
    shape = tuple(new.image.shape)
    dev = new.image.device
    step = 32
    sy, sx, _, _ = remap_grid_coarse(ref.wcs, new.wcs, shape, step=step)
    ranges = grid_shift_ranges(sy, sx, step=step, blocks=8)
    span = max(max(r1 - r0 for r0, r1 in ranges[0]),
               max(r1 - r0 for r0, r1 in ranges[1]))
    # second-order displacement bound of the two-pass form:
    # |d(ys)/dx| * |dxs| (and symmetric) must stay well under a pixel
    dy_dx = float(np.max(np.abs(np.diff(sy, axis=1)))) / step
    dx_dy = float(np.max(np.abs(np.diff(sx, axis=0)))) / step
    rmax = max(abs(v) for pair in ranges[0] + ranges[1] for v in pair)
    fast = span <= 40 and max(dy_dx, dx_dy) * rmax < 0.05
    if fast:
        grid_c = (torch.as_tensor(sy, dtype=torch.float32, device=dev),
                  torch.as_tensor(sx, dtype=torch.float32, device=dev))
    else:
        # rare/wild mappings: exact slab-blocked gathers over the full
        # coordinate planes (host f64 build, slow but correct)
        ys_f, xs_f = remap_grid(ref.wcs, new.wcs, shape, step=step)
        grid_c = (torch.as_tensor(ys_f, device=dev),
                  torch.as_tensor(xs_f, device=dev))

    fratio, fstd, dx_rms, dy_rms, nmatch = _measure_scaling(new, ref)
    zp = dataclasses.replace(zogy_params, dx=dx_rms, dy=dy_rms)

    # PSF stamps at the frame centre (full-frame statistics; the
    # spatial variation enters through the per-position PSF fluxes that
    # were already measured with the varying model)
    cy, cx = 0.5 * shape[0], 0.5 * shape[1]
    psf_n = psf_at(new.psf, cx, cy)
    # ref PSF sampled at the ref-frame pixel that lands at the new centre
    ra, dec = new.wcs.pix2sky(cx, cy)
    rcx, rcy = ref.wcs.sky2pix(ra, dec)
    psf_r = psf_at(ref.psf, float(rcx), float(rcy))

    sn = median(new.bkg_std)
    sr = median(ref.bkg_std)
    # off-frame fill: neutral STD (a huge sentinel would overflow the
    # float32 FFT of the variance map and corrupt V_S everywhere); the
    # EDGE mask bit rejects those regions downstream
    srcs3 = (ref.image - ref.bkg, ref.bkg_std, ref.mask)
    modes3 = ("lanczos", "nearest", "nearest")
    fills3 = (0.0, sr, maskbits.EDGE)
    if fast:
        ref_sub, ref_std_r, ref_mask_r = warp_shift2pass(
            srcs3, modes3, fills3, (grid_c[0], grid_c[1], step), ranges)
    else:
        block = next(b for b in (1320, 660, 264, 132, 60, 22, 11,
                                 8, 4, 2, 1) if shape[0] % b == 0)
        margin = grid_row_margin(sy, step=step)
        ref_sub, ref_std_r, ref_mask_r = resample_blocked(
            srcs3, modes3, fills3, grid_c, block_rows=block,
            margin=max(margin, block // 4))
    del srcs3, grid_c
    new_sub = new.image - new.bkg

    # smooth background-variance maps + spectral Poisson source term
    out = zogy_subtract(new_sub, ref_sub, psf_n, psf_r, sn, sr,
                        fn=1.0, fr=torch.tensor(fratio, dtype=torch.float32,
                                                device=dev),
                        var_bkg_new=new.bkg_std ** 2,
                        var_bkg_ref=ref_std_r ** 2, params=zp,
                        want_psf_d=False)
    del new_sub, ref_std_r
    cat, ntrans = extract_transients(out, new.mask, ref_mask_r,
                                     trans_params)

    stats = {
        "z_fratio": fratio, "z_fratio_std": fstd,
        "z_dxrms": dx_rms, "z_dyrms": dy_rms, "z_nmatch": nmatch,
        "z_fd": float(out["F_D"]),
        "z_scorr_std": float(torch.std(out["Scorr"], correction=0)),
    }
    stats.update({k: int(v)
                  for k, v in transient_stats(cat, ntrans).items()})
    return SubtractionResult(D=out["D"], Scorr=out["Scorr"],
                             Fpsf=out["Fpsf"], Fpsferr=out["Fpsferr"],
                             trans_cat=cat, stats=stats,
                             ref_remapped=ref_sub)
