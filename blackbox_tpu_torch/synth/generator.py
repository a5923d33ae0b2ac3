"""Synthetic raw-frame generator.

Produces MeerLICHT/BlackGEM-like raw frames with known ground truth: per
channel bias level + row drift + column structure (captured by the overscan
strips), flat field with vignetting, Moffat/Gaussian stars on a sky
background, cosmic-ray hits, a satellite trail, and saturated pixels.  This
is both the test fixture (the reference has no test suite — SURVEY.md §4)
and the input for the benchmark harness.

All images are generated in numpy on the host; geometry is parametric via
:class:`blackbox_tpu_torch.core.geometry.CCDGeometry`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from blackbox_tpu_torch.core.geometry import CCDGeometry


@dataclasses.dataclass
class SynthTruth:
    """Ground truth for one synthetic frame (all in reduced-mosaic coords)."""

    bias_level: np.ndarray          # (C,) ADU
    rdnoise_adu: np.ndarray         # (C,) ADU
    row_drift: np.ndarray           # (C, dy) ADU added per raw row
    col_structure: np.ndarray       # (C, dx) ADU added per raw column
    gain: np.ndarray                # (C,) e-/ADU used to convert e- -> ADU
    flat: Optional[np.ndarray] = None         # (H, W) unit-mean flat
    sky: float = 0.0                          # e-/pix
    stars: Optional[np.ndarray] = None        # (N, 4): x, y, flux[e-], fwhm
    cosmics: Optional[np.ndarray] = None      # (M, 3): x, y, amplitude[e-]
    trail: Optional[tuple] = None             # (x0, y0, x1, y1, flux/pix)
    satpix: Optional[np.ndarray] = None       # bool (H, W) of truly saturated


def _bias_structure(geom: CCDGeometry, rng: np.random.Generator):
    C = geom.n_chan
    bias_level = rng.uniform(7000.0, 8000.0, C).astype(np.float32)
    rdnoise_adu = rng.uniform(4.0, 6.0, C).astype(np.float32)
    # smooth row drift: low-order polynomial per channel, few-ADU scale
    y = np.linspace(-1, 1, geom.dy, dtype=np.float32)
    coef = rng.normal(0, 1.5, (C, 4)).astype(np.float32)
    row_drift = (coef[:, 0:1] * y + coef[:, 1:2] * y**2
                 + coef[:, 2:3] * y**3 + coef[:, 3:4] * 0.5 * (3*y**2 - 1))
    # column structure: smooth + a couple of "hot" columns, ~1 ADU scale
    x = np.linspace(-1, 1, geom.dx, dtype=np.float32)
    ccoef = rng.normal(0, 0.8, (C, 3)).astype(np.float32)
    col = ccoef[:, 0:1] * x + ccoef[:, 1:2] * x**2 + ccoef[:, 2:3] * x**3
    return bias_level, rdnoise_adu, row_drift.astype(np.float32), col.astype(np.float32)


def _assemble_raw(geom: CCDGeometry, chan_full: np.ndarray) -> np.ndarray:
    """(C, dy, dx) channel images (incl. overscan regions) -> raw mosaic."""
    ny, nx = geom.ny, geom.nx
    m = chan_full.reshape(ny, nx, geom.dy, geom.dx).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(m.reshape(geom.raw_shape))


def _embed_data(geom: CCDGeometry, chan_full: np.ndarray,
                chan_data: np.ndarray) -> None:
    """Write (C, ych, xch) data sections into (C, dy, dx) channel images."""
    ych, xch = geom.ysize_chan, geom.xsize_chan
    nx = geom.nx
    chan_full[:nx, :ych, :xch] = chan_data[:nx]
    chan_full[nx:, geom.ysize_os:, :xch] = chan_data[nx:]


def star_image(shape, stars, fwhm_default=3.0, moffat_beta=2.5,
               supersample=1):
    """Render stars as Moffat profiles onto an (H, W) image.

    ``stars`` is (N, 4): x, y, total flux, fwhm (fwhm<=0 -> default).
    Rendering is exact enough for photometric tests: each star stamps a
    33x33 window with an analytically normalised Moffat profile.
    """
    H, W = shape
    img = np.zeros((H, W), np.float64)
    half = 16
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    for x, y, flux, fwhm in np.atleast_2d(stars):
        if fwhm <= 0:
            fwhm = fwhm_default
        alpha = fwhm / (2 * np.sqrt(2 ** (1 / moffat_beta) - 1))
        ix, iy = int(round(x)), int(round(y))
        dx, dy = x - ix, y - iy
        r2 = (xx - dx) ** 2 + (yy - dy) ** 2
        prof = (moffat_beta - 1) / (np.pi * alpha ** 2) * \
            (1 + r2 / alpha ** 2) ** (-moffat_beta)
        y0, y1 = max(0, iy - half), min(H, iy + half + 1)
        x0, x1 = max(0, ix - half), min(W, ix + half + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        img[y0:y1, x0:x1] += flux * prof[y0 - (iy - half):y1 - (iy - half),
                                         x0 - (ix - half):x1 - (ix - half)]
    return img


def _vignette_flat(geom: CCDGeometry, rng: np.random.Generator):
    H, W = geom.red_shape
    y = (np.arange(H, dtype=np.float32) - H / 2) / (H / 2)
    x = (np.arange(W, dtype=np.float32) - W / 2) / (W / 2)
    r2 = y[:, None] ** 2 + x[None, :] ** 2
    if H * W > 3e7:            # fast path (see make_raw_science)
        flat = 1.0 - 0.06 * r2
        flat = flat * (1.0 + 0.01 * rng.standard_normal(
            (H, W), dtype=np.float32))
    else:
        flat = (1.0 - 0.06 * r2
                + 0.01 * rng.standard_normal((H, W)).astype(np.float32)
                * 0.0)
        # pixel-to-pixel response at the 1% level
        flat = flat * (1.0 + 0.01 * rng.standard_normal(
            (H, W)).astype(np.float32))
    return (flat / np.mean(flat)).astype(np.float32)


def _electrons_to_raw(geom, rng, data_e, truth, poisson=True):
    """(H, W) e- image -> raw ADU mosaic with bias/overscan structure."""
    C = geom.n_chan
    gain = truth.gain
    # to channel stack, divide by per-channel gain -> ADU
    chan = geom.disassemble(data_e) if data_e.ndim == 2 else data_e
    if poisson:
        lam = np.clip(chan, 0, None)
        if lam.size > 3e7:     # fast normal approximation at full size
            chan = (lam + np.sqrt(lam) * rng.standard_normal(
                lam.shape, dtype=np.float32)).astype(np.float32)
        else:
            chan = rng.poisson(lam).astype(np.float32)
    chan_adu = chan / gain[:, None, None]

    chan_full = np.zeros((C, geom.dy, geom.dx), np.float32)
    _embed_data(geom, chan_full, chan_adu.astype(np.float32))
    # bias + drift + column structure + read noise over the FULL channel
    chan_full += truth.bias_level[:, None, None]
    chan_full += truth.row_drift[:, :, None]
    chan_full += truth.col_structure[:, None, :]
    if chan_full.size > 3e7:   # fast path (see make_raw_science)
        chan_full += (rng.standard_normal(chan_full.shape,
                                          dtype=np.float32)
                      * truth.rdnoise_adu[:, None, None])
    else:
        chan_full += rng.normal(0, truth.rdnoise_adu[:, None, None],
                                chan_full.shape).astype(np.float32)
    return _assemble_raw(geom, chan_full)


def make_raw_bias(geom: CCDGeometry, rng: np.random.Generator,
                  telescope: str = "ML1"):
    from blackbox_tpu_torch.config.defaults import GAIN
    from blackbox_tpu_torch.config.base import get_par
    C = geom.n_chan
    gain = np.resize(np.asarray(get_par(GAIN, telescope), np.float32), C)
    bl, rn, rd, cs = _bias_structure(geom, rng)
    truth = SynthTruth(bias_level=bl, rdnoise_adu=rn, row_drift=rd,
                       col_structure=cs, gain=gain)
    raw = _electrons_to_raw(geom, rng, np.zeros(geom.red_shape, np.float32),
                            truth, poisson=False)
    return raw, truth


def make_raw_dark(geom: CCDGeometry, rng: np.random.Generator,
                  telescope: str = "ML1", exptime: float = 60.0,
                  dark_rate_e: float = 0.5):
    """Dark frame: bias structure + exposure-scaled dark current."""
    from blackbox_tpu_torch.config.defaults import GAIN
    from blackbox_tpu_torch.config.base import get_par
    C = geom.n_chan
    gain = np.resize(np.asarray(get_par(GAIN, telescope), np.float32), C)
    bl, rn, rd, cs = _bias_structure(geom, rng)
    truth = SynthTruth(bias_level=bl, rdnoise_adu=rn, row_drift=rd,
                       col_structure=cs, gain=gain)
    dark_e = np.full(geom.red_shape, dark_rate_e * exptime, np.float32)
    raw = _electrons_to_raw(geom, rng, dark_e, truth, poisson=True)
    return raw, truth


def make_raw_flat(geom: CCDGeometry, rng: np.random.Generator,
                  telescope: str = "ML1", level_e: float = 30000.0,
                  flat: Optional[np.ndarray] = None):
    from blackbox_tpu_torch.config.defaults import GAIN
    from blackbox_tpu_torch.config.base import get_par
    C = geom.n_chan
    gain = np.resize(np.asarray(get_par(GAIN, telescope), np.float32), C)
    bl, rn, rd, cs = _bias_structure(geom, rng)
    if flat is None:
        flat = _vignette_flat(geom, rng)
    truth = SynthTruth(bias_level=bl, rdnoise_adu=rn, row_drift=rd,
                       col_structure=cs, gain=gain, flat=flat)
    data_e = level_e * flat
    raw = _electrons_to_raw(geom, rng, data_e, truth, poisson=True)
    return raw, truth


def make_raw_science(geom: CCDGeometry, rng: np.random.Generator,
                     telescope: str = "ML1", nstars: int = 200,
                     sky_e: float = 300.0, fwhm: float = 3.0,
                     ncosmics: int = 50, trail: bool = True,
                     nsat: int = 3, flat: Optional[np.ndarray] = None,
                     flux_range=(2e3, 2e5),
                     stars: Optional[np.ndarray] = None,
                     trail_frac: float = 1.0):
    """Full synthetic science frame.  Returns (raw_adu, truth).

    ``stars`` (N, 4: x, y, flux, fwhm) fixes the star field — repeated
    visits of the same survey field share their stars.
    """
    from blackbox_tpu_torch.config.defaults import GAIN, SATLEVEL
    from blackbox_tpu_torch.config.base import get_par
    C = geom.n_chan
    H, W = geom.red_shape
    gain = np.resize(np.asarray(get_par(GAIN, telescope), np.float32), C)
    satlevel = np.resize(np.asarray(get_par(SATLEVEL, telescope), np.float32), C)
    bl, rn, rd, cs = _bias_structure(geom, rng)
    if flat is None:
        flat = _vignette_flat(geom, rng)

    if stars is None:
        # stars (kept off the extreme edges)
        xs = rng.uniform(8, W - 8, nstars)
        ys = rng.uniform(8, H - 8, nstars)
        fluxes = np.exp(rng.uniform(np.log(flux_range[0]),
                                    np.log(flux_range[1]), nstars))
        stars = np.stack([xs, ys, fluxes, np.full(nstars, fwhm)], axis=1)
    else:
        stars = np.array(stars, np.float64)
    data_e = star_image((H, W), stars, fwhm_default=fwhm)

    # a few saturating stars
    if nsat:
        satstars = np.stack([
            rng.uniform(20, W - 20, nsat), rng.uniform(20, H - 20, nsat),
            np.full(nsat, 5e7), np.full(nsat, fwhm)], axis=1)
        data_e += star_image((H, W), satstars, fwhm_default=fwhm)
        stars = np.concatenate([stars, satstars], axis=0)

    data_e += sky_e
    data_e = data_e * flat

    chan = geom.disassemble(data_e.astype(np.float32))
    lam = np.clip(chan, 0, None)
    if lam.size > 3e7:
        # full-frame generation: exact per-pixel Poisson draws cost
        # minutes on host; with sky_e ~ 300 e- the normal approximation
        # is indistinguishable.  Small (test) geometries keep the exact
        # draws so test RNG streams stay bit-identical.
        chan = (lam + np.sqrt(lam)
                * rng.standard_normal(lam.shape, dtype=np.float32))
        chan = chan.astype(np.float32)
    else:
        chan = rng.poisson(lam).astype(np.float32)

    # cosmic rays: sharp 1-3 pixel deposits, bypassing the PSF
    cx = rng.uniform(4, W - 4, ncosmics)
    cy = rng.uniform(4, H - 4, ncosmics)
    camp = rng.uniform(3000.0, 40000.0, ncosmics)
    cr_img = np.zeros((H, W), np.float32)
    for x, y, a in zip(cx, cy, camp):
        ix, iy = int(x), int(y)
        cr_img[iy, ix] += a
        # sometimes a short streak of 1-2 extra pixels
        for k in range(rng.integers(0, 3)):
            ddx, ddy = rng.integers(-1, 2), rng.integers(-1, 2)
            if 0 <= iy + ddy < H and 0 <= ix + ddx < W:
                cr_img[iy + ddy, ix + ddx] += a * 0.6
    chan += geom.disassemble(cr_img)
    cosmics = np.stack([cx, cy, camp], axis=1)

    # satellite trail: a bright line across the frame
    trail_params = None
    if trail:
        x0, y0 = rng.uniform(0, W / 4), rng.uniform(0, H)
        x1, y1 = rng.uniform(3 * W / 4, W), rng.uniform(0, H)
        if trail_frac < 1.0:
            # PARTIAL streak (tumbling satellite / glint / trail
            # entering mid-exposure): keep only a trail_frac-length
            # stretch of the line, randomly placed along it — the
            # regime the tiled segment detector exists for
            s0 = rng.uniform(0.0, 1.0 - trail_frac)
            x0, y0, x1, y1 = (x0 + s0 * (x1 - x0),
                              y0 + s0 * (y1 - y0),
                              x0 + (s0 + trail_frac) * (x1 - x0),
                              y0 + (s0 + trail_frac) * (y1 - y0))
        npts = int(2.5 * max(abs(x1 - x0), abs(y1 - y0)))
        ts = np.linspace(0, 1, max(npts, 2))
        txs = (x0 + ts * (x1 - x0)).astype(int)
        tys = (y0 + ts * (y1 - y0)).astype(int)
        ok = (txs >= 0) & (txs < W) & (tys >= 0) & (tys < H)
        tr_img = np.zeros((H, W), np.float32)
        tr_img[tys[ok], txs[ok]] = 4000.0
        # realistic PSF-convolved cross-section (sigma ~ fwhm/2.355):
        # a 1-px-sharp line reads as a cosmic ray to L.A.Cosmic, which
        # real trails do not
        from scipy import ndimage
        sig = max(fwhm / 2.355, 0.8)
        tr = ndimage.gaussian_filter(tr_img, sig, truncate=3.0)
        tr *= 4000.0 / max(tr.max(), 1e-9)
        chan += geom.disassemble(tr.astype(np.float32))
        trail_params = (x0, y0, x1, y1, 4000.0)

    # saturation clipping happens in ADU below
    chan_adu = chan / gain[:, None, None]
    sat_adu = satlevel[:C]
    satpix_chan = chan_adu > sat_adu[:, None, None] * 1.0
    chan_adu = np.minimum(chan_adu, (sat_adu * 1.05)[:, None, None])

    truth = SynthTruth(bias_level=bl, rdnoise_adu=rn, row_drift=rd,
                       col_structure=cs, gain=gain, flat=flat, sky=sky_e,
                       stars=stars, cosmics=cosmics, trail=trail_params,
                       satpix=geom.assemble(satpix_chan))

    C_full = np.zeros((C, geom.dy, geom.dx), np.float32)
    _embed_data(geom, C_full, chan_adu.astype(np.float32))
    C_full += bl[:, None, None]
    C_full += rd[:, :, None]
    C_full += cs[:, None, :]
    if C_full.size > 3e7:
        # fast path (see above): numpy's broadcast-scale normal draws
        # run ~10x slower than a flat standard_normal + multiply
        C_full += (rng.standard_normal(C_full.shape, dtype=np.float32)
                   * rn[:, None, None])
    else:
        C_full += rng.normal(0, rn[:, None, None],
                             C_full.shape).astype(np.float32)
    return _assemble_raw(geom, C_full), truth
