"""Photometric calibration: zeropoint, limiting magnitude, flux scaling.

The reference's photometric calibration lives inside zogy (PC-ZP /
PC-ZPSTD / LIMMAG keywords checked by set_qc; apply_zp_* consumed by
buildref, reference buildref.py:2782-3014).  Here: match detections
to a calibrated reference catalog, sigma-clip the per-star zeropoints,
and derive the survey's standard keywords.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ZeroPoint:
    zp: float                # [mag] instrumental zeropoint (1 e-/s <-> mag)
    zp_std: float            # [mag] scatter over calibration stars
    nstars: int
    ok: bool


def fit_zeropoint(inst_flux, inst_fluxerr, matched_mag, exptime: float,
                  airmass=1.0, ext_coeff: float = 0.0,
                  sigma: float = 2.5, iters: int = 3) -> ZeroPoint:
    """zp = mag_ref + 2.5 log10(flux/exptime) + k*airmass, clipped mean."""
    flux = np.asarray(inst_flux, np.float64)
    good = (flux > 0) & np.isfinite(matched_mag)
    if good.sum() < 3:
        return ZeroPoint(float("nan"), float("nan"), int(good.sum()), False)
    am = (np.asarray(airmass)[good] if np.ndim(airmass)
          else airmass)
    zps = (np.asarray(matched_mag)[good]
           + 2.5 * np.log10(flux[good] / max(exptime, 1e-9))
           + ext_coeff * am)
    # median + MAD clipping: blended stars measure bright (low zp) and
    # survive a mean/std clip, biasing the zeropoint by >0.1 mag
    keep = np.ones(len(zps), bool)
    for _ in range(iters):
        m = np.median(zps[keep])
        s = 1.4826 * np.median(np.abs(zps[keep] - m))
        if s == 0:
            break
        keep = np.abs(zps - m) <= sigma * s
    if keep.sum() < 3:
        keep = np.ones(len(zps), bool)
    return ZeroPoint(float(np.median(zps[keep])),
                     float(zps[keep].std()), int(keep.sum()), True)


def limiting_magnitude(zp: float, bkg_std_med: float, fwhm_pix: float,
                       exptime: float, nsigma: float = 5.0,
                       airmass: float = 1.0,
                       ext_coeff: float = 0.0) -> float:
    """N-sigma point-source limiting magnitude from the background noise.

    Noise in a matched aperture ~ bkg_std * sqrt(A_eff) with
    A_eff = 4*pi*sigma_psf^2 for a Gaussian profile.
    """
    sigma_psf = fwhm_pix / 2.3548
    aeff = 4.0 * np.pi * sigma_psf ** 2
    flux_lim = nsigma * bkg_std_med * np.sqrt(aeff)
    return float(zp - 2.5 * np.log10(flux_lim / max(exptime, 1e-9))
                 - ext_coeff * airmass)


def zp_mag2flux(mag, zp: float, exptime: float, airmass=1.0,
                ext_coeff: float = 0.0):
    """Reference-catalog magnitude -> expected instrument flux [e-]
    (zogy apply_zp_mag2flux equivalent)."""
    return exptime * 10.0 ** (
        -0.4 * (np.asarray(mag, np.float64) - zp
                + ext_coeff * np.asarray(airmass, np.float64)))


def match_catalogs(x, y, ref_x, ref_y, radius_pix: float = 2.0):
    """Nearest-neighbour positional match; returns (idx_det, idx_ref)."""
    x = np.asarray(x)
    y = np.asarray(y)
    rx = np.asarray(ref_x)
    ry = np.asarray(ref_y)
    d2 = (x[:, None] - rx[None, :]) ** 2 + (y[:, None] - ry[None, :]) ** 2
    j = np.argmin(d2, axis=1)
    d = np.sqrt(d2[np.arange(len(x)), j])
    sel = d < radius_pix
    return np.flatnonzero(sel), j[sel]
