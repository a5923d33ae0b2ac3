"""Seeded astrometric solution (plate solve against a reference catalog).

The reference shells out to Astrometry.net's solve-field through zogy
(SURVEY.md §2.4) — but the mount pointing is always known to within ~10
arcmin (reference blackbox.py:5599-5647 checks it against the field grid),
so the production path here is a *seeded* solve: project the reference
stars (Gaia) around the pointing, match the brightest detections by
position with an iteratively refined linear transform, and fit a TAN WCS
(CD matrix + CRVAL) by least squares.  The C++ quad-hash blind-solve
fallback for lost-pointing recovery lives in
:mod:`blackbox_tpu_torch.astro.blindsolve` (csrc/quadmatch.cpp).

Runs on host in float64: the solve involves a few hundred stars — device
offload would be all launch overhead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blackbox_tpu_torch.astro.wcs import TanWCS, D2R


@dataclasses.dataclass
class SolveResult:
    wcs: TanWCS
    nmatch: int
    rms_arcsec: float
    ok: bool


def solve_tan(x, y, flux, ref_ra, ref_dec, ref_mag, guess: TanWCS,
              match_radius_pix: float = 10.0, n_bright: int = 400,
              min_match: int = 10, iters: int = 3) -> SolveResult:
    """Fit a TAN WCS given detections and a reference catalog.

    x, y, flux          : detected sources (0-based pixel coords)
    ref_ra/dec/mag      : reference stars covering the field [deg, mag]
    guess               : initial WCS (pointing + nominal scale/rotation)
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    order = np.argsort(-np.asarray(flux))[:n_bright]
    xs, ys = x[order], y[order]

    bright_ref = np.argsort(np.asarray(ref_mag))[:2 * n_bright]
    rra = np.asarray(ref_ra, np.float64)[bright_ref]
    rdec = np.asarray(ref_dec, np.float64)[bright_ref]

    wcs = guess
    nmatch, rms = 0, np.inf

    # coarse alignment: the mount pointing can be off by many arcmin
    # (hundreds of pixels) — find the bulk (dx, dy) as the peak of the
    # 2-D histogram of all detection-vs-reference offsets
    rx, ry = wcs.sky2pix(rra, rdec)
    dx = xs[:, None] - rx[None, :]
    dy = ys[:, None] - ry[None, :]
    span = 10.0 * 60.0 / (wcs.pixscale + 1e-12)    # +-10 arcmin in pixels
    bins = max(int(2 * span / 20.0), 10)
    hist, xe, ye = np.histogram2d(dx.ravel(), dy.ravel(), bins=bins,
                                  range=[[-span, span], [-span, span]])
    i, j = np.unravel_index(np.argmax(hist), hist.shape)
    sx = 0.5 * (xe[i] + xe[i + 1])
    sy = 0.5 * (ye[j] + ye[j + 1])
    if hist[i, j] >= min_match:
        # move CRVAL so the projected refs land on the detections
        ra_c, dec_c = wcs.pix2sky(wcs.crpix1 - 1 - sx, wcs.crpix2 - 1 - sy)
        wcs = TanWCS(float(ra_c), float(dec_c), wcs.crpix1, wcs.crpix2,
                     wcs.cd.copy())
        match_radius_pix = max(match_radius_pix, 25.0)

    for it in range(iters):
        rx, ry = wcs.sky2pix(rra, rdec)
        # nearest-detection match within the radius
        d2 = (xs[:, None] - rx[None, :]) ** 2 + \
            (ys[:, None] - ry[None, :]) ** 2
        jbest = np.argmin(d2, axis=1)
        dbest = np.sqrt(d2[np.arange(len(xs)), jbest])
        tol = match_radius_pix if it == 0 else max(2.0,
                                                  match_radius_pix / 3)
        sel = dbest < tol
        if sel.sum() < min_match:
            return SolveResult(wcs, int(sel.sum()), float("inf"), False)

        # linear fit pixel -> tangent plane (6-parameter affine)
        xi, eta = wcs.sky2tan(rra[jbest[sel]], rdec[jbest[sel]])
        A = np.stack([xs[sel] + 1 - wcs.crpix1,
                      ys[sel] + 1 - wcs.crpix2,
                      np.ones(sel.sum())], axis=1)
        cx, resx, *_ = np.linalg.lstsq(A, xi, rcond=None)
        cy, resy, *_ = np.linalg.lstsq(A, eta, rcond=None)
        cd = np.array([[cx[0], cx[1]], [cy[0], cy[1]]], np.float64)
        # shift CRVAL by the fitted offset (evaluated at the ref pixel)
        ra_new, dec_new = wcs.tan2sky(cx[2], cy[2])
        wcs = TanWCS(float(ra_new), float(dec_new), wcs.crpix1,
                     wcs.crpix2, cd)

        # residuals in arcsec
        xi2, eta2 = wcs.sky2tan(rra[jbest[sel]], rdec[jbest[sel]])
        px = cd[0, 0] * A[:, 0] + cd[0, 1] * A[:, 1]
        py = cd[1, 0] * A[:, 0] + cd[1, 1] * A[:, 1]
        rms = float(np.sqrt(np.mean((px - xi2) ** 2 + (py - eta2) ** 2))
                    * 3600.0)
        nmatch = int(sel.sum())

    return SolveResult(wcs, nmatch, rms, True)


def radec_offset_arcmin(wcs: TanWCS, ra_grid: float,
                        dec_grid: float) -> float:
    """RADECOFF: separation of the solved centre vs the field-grid
    definition (reference blackbox.py:5529-5594)."""
    from blackbox_tpu_torch.astro.wcs import haversine
    return float(haversine(wcs.crval1, wcs.crval2, ra_grid,
                           dec_grid) * 60.0)
