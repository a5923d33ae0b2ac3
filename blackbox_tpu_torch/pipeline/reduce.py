"""The per-frame reduction: raw channel stacks -> calibrated mosaic +
mask + catalog (port of :mod:`blackbox_tpu.pipeline.reduce`).

Step order follows the JAX package: gain -> overscan -> non-linearity
-> master bias -> mask -> flat -> L.A.Cosmic -> crosstalk -> satellite
trails -> edge fill -> background -> detection -> moments -> aperture
photometry -> PSF fit and PSF photometry.  The functions run eagerly on
the tensors' device; the hand-written CUDA kernels (label propagation,
k x k medians, window gathers, the fused detection under
``BBTPU_PALLAS_DETECT=1``, and the fused L.A.Cosmic iteration under
``LACosmicParams(use_pallas=True)``) are reached through their ``ops``
wrappers.  The entry point :func:`make_reduce_fn` moves its inputs to
the card unless it is asked for another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackbox_tpu_torch.config import ReductionSettings, get_par
from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.core.geometry import CCDGeometry
from blackbox_tpu_torch.ops.background import background_mesh, mini2back
from blackbox_tpu_torch.ops.cosmics import LACosmicParams, lacosmic
from blackbox_tpu_torch.ops.detection import (DetectParams, detect_segments,
                                              moments_shape, segment_catalog)
from blackbox_tpu_torch.ops.gain import gain_correct
from blackbox_tpu_torch.ops.labeling import euler_count
from blackbox_tpu_torch.ops.masking import build_mask
from blackbox_tpu_torch.ops.morphology import fill_holes
from blackbox_tpu_torch.ops.nonlin import nonlin_correct
from blackbox_tpu_torch.ops.overscan import OverscanParams, overscan_correct
from blackbox_tpu_torch.ops.photometry import aperture_photometry
from blackbox_tpu_torch.ops.psf import (PSFParams, build_psf, psf_at,
                                        psf_fwhm, psf_photometry)
from blackbox_tpu_torch.ops.satdet import (SatDetParams, detect_trail_segments,
                                          detect_trails)
from blackbox_tpu_torch.ops.stats import masked_median, median
from blackbox_tpu_torch.ops.xtalk import xtalk_correct, xtalk_correct_mosaic
from blackbox_tpu_torch.utils.timing import span

# ReduceContext fields holding a frozen parameter dataclass
_NESTED = {"geom": CCDGeometry, "os_params": OverscanParams,
           "lac_params": LACosmicParams, "sat_params": SatDetParams,
           "det_params": DetectParams, "psf_params": PSFParams}


@dataclasses.dataclass(frozen=True)
class ReduceContext:
    """Static per-telescope configuration of the reduction."""

    geom: CCDGeometry
    gains: tuple                    # (C,) e-/ADU
    satlevel_adu: tuple             # (C,) raw ADU
    telescope: str = "ML1"
    os_params: OverscanParams = OverscanParams()
    lac_params: LACosmicParams = LACosmicParams()
    sat_params: SatDetParams = SatDetParams()
    det_params: DetectParams = DetectParams()
    psf_params: PSFParams = PSFParams()
    fit_psf: bool = True
    bkg_boxsize: int = 256
    bkg_filtersize: int = 3
    bkg_nsigma: float = 3.0
    apphot_radii: tuple = (2.0, 4.5, 15.0)   # pixels
    correct_nonlin: bool = False
    subtract_mbias: bool = False
    detect_sats: bool = True
    detect_sat_segments: bool = False
    fwhm_guess: float = 3.0

    @classmethod
    def from_settings(cls, s: ReductionSettings, telescope: str = "ML1",
                      **overrides):
        """The context the JAX package's ``ReduceContext.from_settings``
        builds from the same settings (a copy of its rules)."""
        geom = s.geometry
        C = geom.n_chan
        gains = np.resize(np.asarray(get_par(s.gain, telescope),
                                     np.float32), C)
        satlev = np.resize(np.asarray(get_par(s.satlevel, telescope),
                                      np.float32), C)
        mode = "ML" if telescope.startswith("ML") else "BG"
        kw = dict(
            geom=geom, gains=tuple(gains.tolist()),
            satlevel_adu=tuple(satlev.tolist()), telescope=telescope,
            os_params=OverscanParams(voscan_poldeg=s.voscan_poldeg,
                                     mode=mode),
            lac_params=LACosmicParams(
                sigclip=float(get_par(s.sigclip, telescope)),
                sigfrac=s.sigfrac, objlim=s.objlim, niter=s.niter,
                sepmed=s.sepmed, windowed=not s.sepmed),
            det_params=DetectParams(nsigma=s.det_nsigma,
                                    npix_min=s.det_npix_min,
                                    max_sources=s.max_sources),
            sat_params=SatDetParams(bin_factor=s.sat_bin),
            # the vignette caps at the 25 px design stamp
            psf_params=PSFParams(size=min(s.size_vignet, 25) | 1),
            bkg_boxsize=min(s.bkg_boxsize, geom.red_shape[0] // 4),
            bkg_filtersize=s.bkg_filtersize,
            bkg_nsigma=s.bkg_nsigma,
            # settings radii are in units of FWHM, resolved to pixels at
            # the nominal 3-px seeing
            apphot_radii=tuple(float(r) * 3.0 for r in s.apphot_radii),
            correct_nonlin=s.correct_nonlin,
            subtract_mbias=bool(get_par(s.subtract_mbias, telescope)),
            detect_sats=s.detect_sats,
            detect_sat_segments=s.detect_sat_segments,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_defaults(cls, geom: CCDGeometry, telescope: str = "ML1",
                      **overrides):
        """:meth:`from_settings` of the default ``ReductionSettings`` on
        ``geom``."""
        return cls.from_settings(ReductionSettings(geometry=geom), telescope,
                                 **overrides)

    @classmethod
    def from_reference(cls, ref):
        """Carry a JAX ``ReduceContext`` across, reading every field by
        attribute name (nested parameter dataclasses included), without
        importing jax."""
        def carry(obj, kind):
            return kind(**{f.name: getattr(obj, f.name)
                           for f in dataclasses.fields(kind)})

        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(ref, f.name)
            kw[f.name] = carry(v, _NESTED[f.name]) if f.name in _NESTED else v
        return cls(**kw)


def _count(m: torch.Tensor) -> torch.Tensor:
    return torch.sum(m, dtype=torch.int32)


def calibrate_detector(ctx: ReduceContext, chan_data, os_vert, os_hori,
                       mbias, mflat, bpm, xtalk_coeffs, nonlin_coeffs=None):
    """Detector calibration: raw channel stacks -> (sci mosaic, mask, stats).

    mbias : (C, ych, xch) master bias [e-] or None
    mflat : (C, ych, xch) normalised master flat or None
    bpm   : (C, ych, xch) uint8 static mask or None
    nonlin_coeffs : (C, D) non-linearity polynomial, applied when
            ``ctx.correct_nonlin`` is set, or None
    """
    with span("calibration"):
        return _calibrate(ctx, chan_data, os_vert, os_hori, mbias, mflat,
                          bpm, xtalk_coeffs, nonlin_coeffs)


def _calibrate(ctx, chan_data, os_vert, os_hori, mbias, mflat, bpm,
               xtalk_coeffs, nonlin_coeffs):
    """:func:`calibrate_detector`'s steps, each stage in a span."""
    geom = ctx.geom
    dev = chan_data.device
    gains = torch.tensor(ctx.gains, dtype=torch.float32, device=dev)
    satlevel_adu = torch.tensor(ctx.satlevel_adu, dtype=torch.float32,
                                device=dev)
    stats = {}

    with span("calibration.overscan"):
        chan, osv, osh = gain_correct(chan_data, os_vert, os_hori, gains)
        chan, os_stats = overscan_correct(chan, osv, osh,
                                          satlevel_e=satlevel_adu * gains,
                                          params=ctx.os_params)
    stats.update(os_stats)

    if ctx.correct_nonlin and nonlin_coeffs is not None:
        chan = nonlin_correct(chan, gains, torch.as_tensor(
            nonlin_coeffs, dtype=torch.float32, device=dev))

    if ctx.subtract_mbias and mbias is not None:
        chan = chan - mbias

    with span("calibration.mask"):
        chan, mask, mstats = build_mask(chan, bpm, satlevel_adu, gains,
                                        os_stats["biasm"], nx=geom.nx)
        stats.update({k: v for k, v in mstats.items() if k != "mask_sat"})
        stats["nobj_sat"] = euler_count(geom.assemble(mstats["mask_sat"]))

    if mflat is not None:
        chan = chan / torch.clamp(mflat, min=1e-3)

    sci = geom.assemble(chan)
    mask_m = geom.assemble(mask)

    # cosmic rays (every already-masked pixel is excluded)
    with span("lacosmic"):
        clean, crmask, _ = lacosmic(sci, mask_m != 0, stats["rdnoise"],
                                    ctx.lac_params)
    mask_m = torch.where(crmask, mask_m | maskbits.COSMIC, mask_m)
    # fill holes before Euler counting: the Euler number equals the
    # component count only for hole-free masks
    stats["ncosmics"] = euler_count(fill_holes(crmask, iterations=1))

    if xtalk_coeffs is not None:
        with span("calibration.xtalk"):
            if geom.ny == 2:
                clean = xtalk_correct_mosaic(clean, mask_m, xtalk_coeffs,
                                             geom.ny, geom.nx)
            else:
                ch = xtalk_correct(geom.disassemble(clean),
                                   geom.disassemble(mask_m), xtalk_coeffs,
                                   geom.nx)
                clean = geom.assemble(ch)

    # satellite trails; EDGE pixels are excluded too (overscan artefacts
    # forming straight lines along the channel seams)
    if ctx.detect_sats:
        with span("calibration.trails"):
            mask_m, stats["nsats"] = _trails(ctx, clean, mask_m)
    else:
        stats["nsats"] = torch.zeros((), dtype=torch.int32, device=dev)

    # edge pixels -> channel median over an 8x8-subsampled grid
    with span("calibration.edge_fill"):
        ch = geom.disassemble(clean)
        mk = geom.disassemble(mask_m)
        C = ch.shape[0]
        ch_s = ch[:, ::8, ::8].reshape(C, -1)
        mk_s = ((mk[:, ::8, ::8] & maskbits.EDGE) != 0).reshape(C, -1)
        chan_med = torch.nan_to_num(masked_median(ch_s, mk_s, axis=1))
        edge = (mk & maskbits.EDGE) != 0
        clean = geom.assemble(torch.where(edge, chan_med[:, None, None], ch))

    # per-bit mask counts for the mask header
    for name, bit in maskbits.BITS.items():
        stats[f"n_{name}"] = _count((mask_m & bit) == bit)
    return clean, mask_m, stats


def _trails(ctx, clean, mask_m):
    """The satellite trails of a frame: (mask with the SATELLITE bit
    set on them, outside EDGE pixels; their number)."""
    excl, seam_rows, seam_cols = trail_exclusion(ctx.geom, mask_m)
    if ctx.detect_sat_segments:
        # full-frame pass first (more sensitive to faint full
        # trails), then the tiled segment pass for short streaks,
        # seeded with the full-frame lines so NSATS counts each
        # physical trail once
        trail_mask, ntrails, _, lines = detect_trails(
            clean, excl, ctx.sat_params, seam_rows=seam_rows,
            seam_cols=seam_cols, want_lines=True)
        seg_mask, n_seg, _ = detect_trail_segments(
            clean, excl, ctx.sat_params, seam_rows=seam_rows,
            seam_cols=seam_cols, exclude_lines=lines)
        trail_mask = trail_mask | seg_mask
        ntrails = ntrails + n_seg
    else:
        trail_mask, ntrails, _ = detect_trails(
            clean, excl, ctx.sat_params, seam_rows=seam_rows,
            seam_cols=seam_cols)
    mask_m = torch.where(trail_mask & ((mask_m & maskbits.EDGE) == 0),
                         mask_m | maskbits.SATELLITE, mask_m)
    return mask_m, ntrails


def trail_exclusion(geom, mask_m):
    """What the trail detector ignores in a frame: its saturated, bad
    and EDGE pixels (overscan artefacts forming straight lines along the
    channel seams), and the seams' full-resolution rows and columns,
    whose axis-aligned detections it vetoes."""
    excl = (mask_m & (maskbits.SATURATED | maskbits.SAT_CONNECTED
                      | maskbits.BAD | maskbits.EDGE)) != 0
    Hr, Wr = geom.red_shape
    seam_rows = tuple(geom.ysize_chan * i
                      for i in range(1, Hr // geom.ysize_chan))
    seam_cols = tuple(geom.xsize_chan * j
                      for j in range(1, Wr // geom.xsize_chan))
    return excl, seam_rows, seam_cols


def extract_catalog(ctx: ReduceContext, sci, mask_m):
    """Background + detection + aperture photometry on a calibrated frame."""
    with span("catalog"):
        with span("catalog.background"):
            bad = mask_m != 0
            mesh, stdm = background_mesh(sci, bad, ctx.bkg_boxsize,
                                         nsigma=ctx.bkg_nsigma,
                                         filtersize=ctx.bkg_filtersize)
            bkg = mini2back(mesh, sci.shape, ctx.bkg_boxsize)
            bstd = mini2back(stdm, sci.shape, ctx.bkg_boxsize)
            sub = sci - bkg
        with span("catalog.detect"):
            excl = (mask_m & (maskbits.EDGE | maskbits.BAD
                              | maskbits.SATELLITE)) != 0
            seg, n = detect_segments(sub, bstd, excl, ctx.det_params)
        return catalog_tail(ctx, sci, sub, bkg, bstd, seg, n, mesh, stdm)


def catalog_tail(ctx: ReduceContext, sci, sub, bkg, bstd, seg, n, mesh,
                 stdm):
    """Per-source stages after segmentation: moments, photometry, PSF."""
    cat = segment_catalog(sub, bstd, seg, n, ctx.det_params)
    cat.update(moments_shape(cat))
    flux, fluxerr = aperture_photometry(sub, bstd, cat["x"], cat["y"],
                                        ctx.apphot_radii, n_active=n)
    cat["flux_ap"] = flux
    cat["fluxerr_ap"] = fluxerr
    cat["snr"] = flux[:, -1] / torch.clamp(fluxerr[:, -1], min=1e-9)

    # image-level stats: seeing = median FWHM of clean bright sources,
    # elongation stats, background level/STD medians
    good = cat["valid"] & (cat["snr"] > 20) & (cat["elong"] < 1.5)
    fwhm_med = masked_median(cat["fwhm"], ~good, axis=0)
    ngood = torch.clamp(_count(good), min=1)
    fmean = torch.sum(torch.where(good, cat["fwhm"], 0.0)) / ngood
    fwhm_std = torch.sqrt(torch.sum(torch.where(
        good, (cat["fwhm"] - fmean) ** 2, 0.0)) / ngood)
    egood = cat["valid"] & (cat["snr"] > 20)
    elong_med = masked_median(cat["elong"], ~egood, axis=0)
    neg = torch.clamp(_count(egood), min=1)
    emean = torch.sum(torch.where(egood, cat["elong"], 0.0)) / neg
    elong_std = torch.sqrt(torch.sum(torch.where(
        egood, (cat["elong"] - emean) ** 2, 0.0)) / neg)
    stats = {
        "nobjects": _count(cat["valid"]),
        "s_seeing_pix": torch.nan_to_num(fwhm_med, nan=ctx.fwhm_guess),
        "s_seestd_pix": torch.nan_to_num(fwhm_std),
        "s_elong": torch.nan_to_num(elong_med, nan=1.0),
        "s_elostd": torch.nan_to_num(elong_std),
        "bkg_median": median(mesh),
        "bkg_std": median(stdm),
    }
    out = {"bkg": bkg, "bkg_std": bstd, "cat": cat, "stats": stats,
           "seg_nsources": n}

    # spatially-varying PSF model + optimal PSF fluxes
    if ctx.fit_psf:
        with span("catalog.psf"):
            model = build_psf(sub, bstd, cat, sci.shape, ctx.psf_params,
                              n_active=n)
            fpsf, fpsf_err = psf_photometry(sub, bstd, model, cat["x"],
                                            cat["y"], n_active=n)
            cat["flux_psf"] = fpsf
            cat["fluxerr_psf"] = fpsf_err
            cen = psf_at(model, 0.5 * sci.shape[1], 0.5 * sci.shape[0])
            stats["psf_nstars"] = model.nstars
            stats["psf_chi2"] = model.chi2
            stats["psf_fwhm_pix"] = psf_fwhm(cen[None])[0]
            out["psf"] = model
    return out


def to_device(x, device):
    """``x`` with every array in it (numpy or tensor, inside dicts,
    tuples and lists too) as a tensor on ``device``; None and Python
    scalars pass through."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return torch.as_tensor(x, device=device)


def make_reduce_fn(ctx: ReduceContext, with_catalog: bool = True,
                   device="cuda"):
    """Build the end-to-end reduce function.

    The returned callable takes ``(chan_data, os_vert, os_hori, mbias,
    mflat, bpm, xtalk_coeffs)`` as tensors or numpy arrays (the
    calibration arrays may be None), moves every one to ``device`` (the
    card unless the caller asks for another, e.g. ``device="cpu"``),
    and returns ``{"image", "mask", "stats"}``, plus, with
    ``with_catalog``, ``{"bkg", "bkg_std", "cat", "seg_nsources"}`` and
    ``"psf"`` (a :class:`PSFModel`) when ``ctx.fit_psf``.
    """
    dev = torch.device(device)

    @torch.inference_mode()
    def fn(chan_data, os_vert, os_hori, mbias, mflat, bpm, xtalk_coeffs):
        with span("reduce"):
            chan_data, os_vert, os_hori, mbias, mflat, bpm, xtalk_coeffs = (
                to_device((chan_data, os_vert, os_hori, mbias, mflat, bpm,
                           xtalk_coeffs), dev))
            sci, mask_m, stats = calibrate_detector(
                ctx, chan_data, os_vert, os_hori, mbias, mflat, bpm,
                xtalk_coeffs)
            out = {"image": sci, "mask": mask_m, "stats": stats}
            if with_catalog:
                ext = extract_catalog(ctx, sci, mask_m)
                out["stats"] = {**stats, **ext.pop("stats")}
                out.update(ext)
            return out

    return fn
