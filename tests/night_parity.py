"""Shared, jax-free helpers of the port's science and driver parity
checks (not a test module): the Scorr tolerances and the near-tie
allowance of ``test_torch_science.py``, the TINY night of
``test_torch_driver.py`` and the comparisons of two runs of it.

``chip_smoke.py`` holds the port's driver on the card against the
port on the CPU with these same helpers, on a machine without jax, so
this module imports numpy and the port only.

The Scorr tolerances: Scorr's V[S] source term is a float32 transform
chain (``test_torch_science.py``'s module note), held at
``SCORR_RTOL`` of itself plus ``SCORR_ATOL``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

SCORR_RTOL = 0.05
SCORR_ATOL = 3e-3


def mask_edge_flips(got, want) -> int:
    """The pixels where two rasterised trail masks differ, all of which
    must lie on ``want``'s edge (a pixel whose 3x3 neighbourhood in
    ``want`` holds both values): the trail detector rasterises each line
    by a distance threshold from cos θ and sin θ, and XLA's, PyTorch's
    CPU and CUDA's float32 cos and sin differ by an ulp at some grid
    angles, which moves a pixel lying at the threshold.  Returns the
    number that differ."""
    got = np.asarray(got, bool)
    want = np.asarray(want, bool)
    diff = got != want
    if not diff.any():
        return 0
    p = np.pad(want, 1, mode="edge")
    H, W = want.shape
    win = [p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    edge = np.any(win, axis=0) & ~np.all(win, axis=0)
    bad = diff & ~edge
    assert not bad.any(), f"{int(bad.sum())} mask pixels differ off the edge"
    return int(diff.sum())

def peak_ties(got_xy, want_xy, scorr):
    """Indices of the transients whose peak pixels differ by a near tie.

    ``got_xy`` and ``want_xy`` are (x, y) arrays of the port's and the
    JAX package's peak pixels, ``scorr`` the JAX package's Scorr map.
    Two pixels tie where they are neighbours (each coordinate within
    1 px) and the map's |Scorr| at the port's pixel is within the Scorr
    tolerance of its value at the JAX pixel.  Raises, naming the
    pixels, on any other difference and where more than one transient
    ties."""
    ties = []
    for i, (gx, gy, wx, wy) in enumerate(zip(*got_xy, *want_xy)):
        g, w = (int(gx), int(gy)), (int(wx), int(wy))
        if g == w:
            continue
        a, b = abs(float(scorr[g[1], g[0]])), abs(float(scorr[w[1], w[0]]))
        near = max(abs(g[0] - w[0]), abs(g[1] - w[1])) <= 1
        if not (near and abs(a - b) <= SCORR_ATOL + SCORR_RTOL * b):
            raise AssertionError(
                f"transient {i}: peak (x, y) = {g} in the port, {w} in the "
                f"JAX package, |Scorr| there {a:.6g} and {b:.6g}: not a "
                "near tie of neighbouring pixels")
        ties.append((i, g, w))
    if len(ties) > 1:
        raise AssertionError(
            f"{len(ties)} transients need the 1-px tie allowance, at most "
            "one may: " + "; ".join(f"transient {i}: port {g}, JAX {w}"
                                    for i, g, w in ties))
    return [i for i, _, _ in ties]


# ---------------------------------------------------------------- night

DATE = "20260301"
PIXSCALE = 0.5642
RA0, DEC0 = 150.0, -30.0
ZP_TRUE = 25.0
TRANS = (221.3, 71.2, 4.0e4)     # x, y [px], flux [e-] of the transient
FLOAT_RTOL = 2e-3                # float header keywords
REF = os.path.join("ML1", "ref", "00042", f"ML1_42_q_{DATE}")


def tiny_night(root):
    """A TINY raw night under ``root``: tests/test_driver.py's night
    (seed 11: 3 bias, 3 flat, one visit of field 42 with 40 stars) and
    a second visit at 23:30 with the transient added.  Returns the
    raw files, in observing order, and the stars' truth (x, y, flux,
    fwhm rows)."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.synth.observation import (
        night_of_observations, write_observation)
    rng = np.random.default_rng(11)
    files, truths, tree = night_of_observations(
        root, TINY, rng, date=DATE, nbias=3, nflat=3, nsci=1, nstars=40,
        ncosmics=10, trail=False, nsat=0, sky_e=300.0, ra_deg=RA0,
        dec_deg=DEC0)
    stars = np.concatenate([truths[-1].stars, [[*TRANS, 3.0]]], axis=0)
    p2 = os.path.join(tree.raw_dir(DATE), f"ML1_{DATE}_233000.fits")
    write_observation(p2, TINY, rng, "object",
                      mjd_start=iso2mjd("2026-03-01T23:30:00.000"),
                      nstars=0, ncosmics=4, trail=False, nsat=0,
                      sky_e=300.0, ra_deg=RA0, dec_deg=DEC0, stars=stars,
                      flat=truths[-1].flat)
    return files + [p2], truths[-1].stars


def ref_catalog(stars, shape, ra0=RA0, dec0=DEC0, exptime=60.0):
    """Calibration-star query (tests/test_driver.py's): the true stars
    through the frame's nominal WCS, magnitudes at ZP_TRUE."""
    from blackbox_tpu_torch.astro.wcs import TanWCS
    wcs = TanWCS.simple(ra0, dec0, PIXSCALE, shape)
    ra, dec = wcs.pix2sky(stars[:, 0], stars[:, 1])
    mag = ZP_TRUE - 2.5 * np.log10(stars[:, 2] / exptime)

    def query(ra_c, dec_c, radius):
        return {"ra": ra, "dec": dec, "mag": mag}
    return query


def tiny_ctx(settings):
    """The port's twin of tests/test_driver.py's ``_ctx``."""
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.ops.satdet import SatDetParams
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    return ReduceContext.from_settings(
        settings, "ML1",
        lac_params=LACosmicParams(sigclip=10.0, strip_rows=66),
        det_params=DetectParams(nsigma=1.5, max_sources=512,
                                label_iters=24),
        sat_params=SatDetParams(bin_factor=2, nsigma=8.0,
                                trail_halfwidth=4),
        bkg_boxsize=33, apphot_radii=(2.0, 4.5, 9.0))


# ---------------------------------------------------------- comparisons
#
# ``a`` is the run under test, ``b`` the one it is held against; each
# run is (results, root): the FrameResults of the night's files in
# order and the root of its data tree.

def overscan_level(run):
    return max(float(r.header[f"BIASM{c}"]) for r in run[0]
               for c in range(1, 17))


def pixel_atol(level):
    """tests/test_torch_reduce.py's pixel atol at overscan level L."""
    return 1e-3 + 1e-5 * level


def pairs(a, b, suffix):
    """(b path, a path) of every product of ``b`` ending in ``suffix``,
    the field reference's too."""
    rels = [os.path.relpath(p, b[1]) for r in b[0] for p in r.products]
    rels += [REF + s for s in ("_red.fits.fz", "_mask.fits.fz",
                               "_bkgstd.fits.fz", "_red_cat.fits")]
    return [(os.path.join(b[1], rel), os.path.join(a[1], rel))
            for rel in sorted(set(rels)) if rel.endswith(suffix)]


def decode(path):
    """Decoded image (float64) and its per-row quantisation step."""
    from blackbox_tpu_torch.io.rice import read_rice
    img, h = read_rice(path)
    step = np.repeat(np.asarray(table(path)["ZSCALE"], np.float64),
                     int(h["ZTILE2"]))[:img.shape[0], None]
    return img.astype(np.float64), step


def table(path):
    from blackbox_tpu_torch.io.fits import read_fits
    return next(d for d, _ in read_fits(path) if isinstance(d, dict))


def check_statuses(a, b):
    for ra, rb in zip(a[0], b[0]):
        assert rb.status == "reduced", rb.error
        assert ra.status == rb.status, ra.error
        assert ra.qc_flag == rb.qc_flag
        names = [sorted(os.path.basename(p) for p in r.products)
                 for r in (ra, rb)]
        assert names[0] == names[1], names


def clip_edge(ha, hb):
    """The photometric calibration's allowance for one star at its clip
    edge, as (zeropoint atol [mag], relative atol of PC-ZPSTD).

    The zeropoint is a median of per-star zeropoints after a 2.5-sigma
    MAD clip; a star that lies at the clip's edge falls on either side
    of it under rounding differences that move its flux by 1e-4.  Where
    the two runs kept the same number of stars nothing is allowed.
    Where they kept n and n + 1, the zeropoint may move by its standard
    error, PC-ZPSTD / sqrt(n), and PC-ZPSTD by the weight of one star
    at 2.5 sigma in n, 2.5**2 / (2 n).  More than one star is not
    allowed."""
    na, nb = ha.get("PC-NCAL"), hb.get("PC-NCAL")
    if na == nb:
        return 0.0, 0.0
    assert na is not None and nb is not None and abs(na - nb) == 1, (na, nb)
    n = min(na, nb)
    std = max(float(ha["PC-ZPSTD"]), float(hb["PC-ZPSTD"]))
    return std / np.sqrt(n), 2.5 ** 2 / (2 * n)


# The float keywords the pipeline rounds before it writes them, with their
# decimals (``round(v, d)`` in blackbox_tpu_torch/pipeline/headers.py,
# driver.py and buildref.py and orchestration/masterstore.py, as in the
# JAX package); a per-channel keyword is listed without its number.
ROUNDED = {
    "GPS-SHUT": 4, "MJD-OBS": 8, "LST": 6, "RA": 6, "DEC": 6,
    "AIRMASS": 4, "ALTITUDE": 3, "AZIMUTH": 3, "RADECOFF": 3,
    "SUNALT": 2, "MOONALT": 2, "MOONILLU": 3, "MOONDIST": 2,
    "GAIN": 3, "BIASM": 2, "RDN": 3, "BIASMEAN": 2, "RDNOISE": 3,
    "SATLEV": 1, "SATURATE": 1, "NCOSMICS": 3,
    "MEDSEC": 2, "STDSEC": 2, "RSTDSEC": 5, "FLATMED": 2, "FLATSTD": 2,
    "FLATRSTD": 5, "FLATM": 2, "FLATS": 2, "FLATRS": 5, "RDIF-MAX": 5,
    "RSTD-MAX": 5,
    "MBMEAN": 3, "MBRDN": 3, "MBIASM": 3, "MDMEAN": 4, "MDRDN": 4,
    "MDARKM": 4, "GAINCF": 5, "OFF-MEAN": 2,
    "S-SEEING": 3, "S-SEEPIX": 3, "S-SEESTD": 3, "S-ELONG": 4,
    "S-ELOSTD": 4, "S-BKG": 2, "S-BKGSTD": 2,
    "PSF-FWHM": 3, "PSF-CHI2": 3, "A-RMS": 4, "PC-ZP": 4, "PC-ZPSTD": 4,
    "LIMMAG": 4, "MC-MED": 3,
    "Z-FRATIO": 4, "Z-FRSTD": 4, "Z-DXRMS": 4, "Z-DYRMS": 4, "Z-SCSTD": 4,
}


def rounding_unit(key) -> float:
    """One unit of the last decimal the pipeline rounds float keyword
    ``key`` to (ROUNDED), else 0: two values within a tolerance, each
    rounded, may land on neighbouring units (Z-FRSTD 0.0184 and 0.0185
    from 0.01845 -/+ 1e-7)."""
    d = ROUNDED.get(key, ROUNDED.get(key.rstrip("0123456789")))
    return 0.0 if d is None else 10.0 ** -d


def check_headers(a, b, level):
    """Same keywords and flags; integer, boolean and string keywords
    equal (PC-NCAL but for ``clip_edge``); magnitudes within 1e-3 mag
    (plus ``clip_edge``); other floats within FLOAT_RTOL, plus the
    pixel atol in e-; a rounded float plus its ``rounding_unit``.  Raises naming
    every keyword that differs."""
    bad = []
    for i, (ra, rb) in enumerate(zip(a[0], b[0])):
        ha, hb = ra.header, rb.header
        assert set(ha.keys()) == set(hb.keys()), (i, set(ha.keys())
                                                  ^ set(hb.keys()))
        flags = [k for k in hb.keys() if k.endswith("-P")]
        assert flags and all(ha[k] == hb[k] for k in flags), flags
        dzp, dstd = clip_edge(ha, hb)
        for k in hb.keys():
            x, y = ha[k], hb[k]
            unit = hb.comment(k)
            if k == "PC-NCAL":
                continue                # clip_edge holds it
            numeric = isinstance(y, float) and not isinstance(x, (bool, str))
            rounding = rounding_unit(k) if numeric else 0.0
            if k == "PC-ZPSTD":
                ok = abs(x - y) <= 1e-3 + dstd * max(x, y) + rounding
            elif isinstance(y, float) and unit.startswith("[mag]"):
                ok = abs(x - y) <= 1e-3 + dzp + rounding
            elif numeric:
                atol = pixel_atol(level) if unit.startswith("[e-]") \
                    else 1e-12
                ok = (abs(x - y) <= FLOAT_RTOL * max(abs(x), abs(y)) + atol
                      + rounding)
            else:
                ok = type(x) is type(y) and x == y
            if not ok:
                bad.append((i, k, x, y))
    assert not bad, bad


def check_masks(a, b):
    from blackbox_tpu_torch.io.rice import read_rice
    found = pairs(a, b, "_mask.fits.fz")
    for pb, pa in found:
        x, _ = read_rice(pa)
        y, _ = read_rice(pb)
        assert x.dtype == y.dtype and np.array_equal(x, y), pa
    return len(found)


def master_flat_rdiff(a, b):
    """Relative difference of the two runs' master flats."""
    rel = os.path.join("ML1", "masters", f"flat_{DATE}_q.fits.fz")
    x, _ = decode(os.path.join(a[1], rel))
    y, _ = decode(os.path.join(b[1], rel))
    return np.abs(x - y) / np.abs(y)


def check_master_flat(a, b):
    """Within the inputs' relative quantisation step plus one step."""
    rel = os.path.join("ML1", "masters", f"flat_{DATE}_q.fits.fz")
    x, _ = decode(os.path.join(a[1], rel))
    y, step = decode(os.path.join(b[1], rel))
    in_rel = 0.0
    for pb, _ in pairs(a, b, "_red.fits.fz"):
        if os.sep + "flat" + os.sep in pb:
            img, st = decode(pb)
            in_rel = max(in_rel, float(st.max()) / float(np.median(img)))
    assert np.all(np.abs(x - y) <= step + in_rel * np.abs(y) + 1e-7)


def check_images(a, b, level):
    """Decoded _red and _bkgstd images within one step plus the pixel
    atol (and the master flat's relative difference on object
    frames)."""
    found = pairs(a, b, "_red.fits.fz") + pairs(a, b, "_bkgstd.fits.fz")
    atol = pixel_atol(level)
    flat = master_flat_rdiff(a, b)
    for pb, pa in found:
        y, step = decode(pb)
        x, _ = decode(pa)
        tol = step + atol + 1e-5 * np.abs(y)
        if not any(os.sep + k + os.sep in pb for k in ("bias", "flat")):
            tol = tol + np.abs(y) * flat
        assert np.all(np.abs(x - y) <= tol), (pa, float(np.abs(x - y).max()))
    return len(found)


def check_difference_images(a, b):
    (db, da), = pairs(a, b, "_D.fits.fz")
    (sb, sa), = pairs(a, b, "_Scorr.fits.fz")
    y, step = decode(db)
    x, _ = decode(da)
    assert np.all(np.abs(x - y) <= step + 2e-4 * np.abs(y).max())
    y, step = decode(sb)
    x, _ = decode(sa)
    assert np.all(np.abs(x - y) <= step + SCORR_ATOL + SCORR_RTOL * np.abs(y))


ERR_OF = {"E_FLUX_": "E_FLUXERR_", "MAG_": "MAGERR_"}


def check_catalogs(a, b):
    """Every catalog product of ``b`` against ``a``'s
    (``check_catalog_pair``); returns their row counts."""
    found = pairs(a, b, "_red_cat.fits")
    for pb, pa in found:
        check_catalog_pair(pa, pb)
    return [len(table(pb)["NUMBER"]) for pb, _ in found]


def check_catalog_pair(pa, pb):
    """Same rows; integer columns exact; positions within 1e-3 px;
    fluxes within 1e-4 of themselves plus a tenth of their error;
    magnitudes within a tenth of their error (plus ``clip_edge``'s
    zeropoint allowance), their errors as moved by that;
    signal-to-noise within 0.1; other floats within 1e-3."""
    cb, ca = table(pb), table(pa)
    # magnitudes carry the zeropoint, which ``clip_edge`` may move
    from blackbox_tpu_torch.io.fits import read_fits
    hb, ha = (next(h for d, h in read_fits(p) if isinstance(d, dict))
              for p in (pb, pa))
    dzp = clip_edge(ha, hb)[0]
    assert list(ca) == list(cb)
    for k, y in cb.items():
        x, y = np.asarray(ca[k]), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, k
        d = np.abs(x.astype(np.float64) - y)
        if y.dtype.kind != "f":
            assert np.array_equal(x, y), k
        elif k in ("X_POS", "Y_POS"):
            assert np.all(d <= 1e-3), k
        elif k in ("RA", "DEC"):
            assert np.all(d <= 1e-3 * PIXSCALE / 3600), k
        elif k.startswith("MAGERR_"):
            assert np.all(d <= np.abs(y) * (1e-3 + 0.1 * np.abs(y)
                                            / 1.0857)), k
        elif k.startswith(("E_FLUX_", "MAG_", "SNR_")):
            pre = next((p for p in ERR_OF if k.startswith(p)), None)
            sig = (np.abs(np.asarray(cb[k.replace(pre, ERR_OF[pre])]))
                   if pre else 1.0)
            zp = dzp if k.startswith("MAG_") else 0.0
            assert np.all(d <= 1e-4 * np.abs(y) + 0.1 * sig + zp), k
        else:
            assert np.all(d <= 1e-3 * np.abs(y) + 1e-6), k


def threshold_band(scorr, step, x, y, nsigma=6.0):
    """The pixels of the transient at (x, y) whose |Scorr| may fall on
    either side of the detection threshold ``nsigma``
    (``TransientParams.nsigma``) between two runs: within the Scorr
    tolerance at the threshold of it, plus half the step of the decoded
    map ``scorr`` (the Rice coding's rounding), in the 8-connected
    region above the band's floor that holds the peak."""
    from scipy import ndimage
    a = np.abs(scorr)
    tol = SCORR_ATOL + SCORR_RTOL * nsigma + 0.5 * step
    lab, _ = ndimage.label(a > nsigma - tol, np.ones((3, 3), bool))
    region = lab == lab[y, x]
    return int((region & (np.abs(a - nsigma) <= tol)).sum())


# ELONG_ZOGY's relative allowance for each pixel a transient's footprint
# gains or loses (NPIX_ZOGY) between two runs, per pixel of the
# footprint: the pixels that move lie at the threshold, so each carries
# at most 1/npix of the |Scorr| weight of the moments, and at the
# footprint's edge, up to ~4 times the weighted second moment away
ELONG_PER_PIXEL = 4.0


def check_transients(a, b, npix_band=False):
    """T-NTRANS equal, peak pixels equal but for a near tie, the rest at
    the Scorr and flux tolerances; returns the (x, y) of ``a``'s
    transients, 0-based.  With ``npix_band`` a transient's pixel count
    (NPIX_ZOGY) may differ by its pixels in ``threshold_band``, printed
    beside each count, and its shape (ELONG_ZOGY) by ELONG_PER_PIXEL
    times the share of its pixels that moved, more."""
    ha, hb = a[0][-1].header, b[0][-1].header
    assert ha["T-NTRANS"] == hb["T-NTRANS"] >= 1
    (tb, ta), = pairs(a, b, "_red_trans.fits")
    (sb, _), = pairs(a, b, "_Scorr.fits.fz")
    cb, ca = table(tb), table(ta)
    assert list(ca) == list(cb) and len(ca["NUMBER"]) == len(cb["NUMBER"])
    scorr, step = decode(sb)
    ax, ay = (np.asarray(ca[k]) - 1 for k in ("X_PEAK", "Y_PEAK"))
    bx, by = (np.asarray(cb[k]) - 1 for k in ("X_PEAK", "Y_PEAK"))
    keep = np.setdiff1d(np.arange(len(ax)),
                        peak_ties((ax, ay), (bx, by), scorr))
    for k in ("X_PEAK", "Y_PEAK", "NUMBER"):
        assert np.array_equal(np.asarray(ca[k])[keep],
                              np.asarray(cb[k])[keep]), k
    npix = [np.asarray(c["NPIX_ZOGY"])[keep] for c in (ca, cb)]
    gap = np.abs(npix[0] - npix[1])
    band = np.array([threshold_band(scorr, float(step.max()), int(bx[i]),
                                    int(by[i])) if npix_band else 0
                     for i in keep], int)
    if npix_band:
        print("transients' NPIX_ZOGY (gap / threshold band): "
              + ", ".join(f"{p} / {q} ({g} / {w})" for p, q, g, w
                          in zip(*npix, gap, band)))
    assert np.all(gap <= band), (npix, band)
    x, y = (np.asarray(c["SNR_ZOGY"])[keep] for c in (ca, cb))
    assert np.all(np.abs(x - y) <= SCORR_ATOL + SCORR_RTOL * np.abs(y))
    moved = ELONG_PER_PIXEL * gap / np.maximum(np.minimum(*npix), 1)
    for k in ("E_FLUX_ZOGY", "ELONG_ZOGY"):
        x, y = (np.asarray(c[k])[keep] for c in (ca, cb))
        rtol = 1e-3 + (moved if k == "ELONG_ZOGY" else 0.0)
        ok = np.abs(x - y) <= rtol * np.abs(y) + 3e-3
        if k == "ELONG_ZOGY" and npix_band:
            print(f"transients' ELONG_ZOGY: {x} / {y}, relative gaps "
                  f"{np.abs(x - y) / np.abs(y)}, allowed {rtol}")
        assert np.all(ok), (k, x, y, rtol)
    return ax, ay


def check_night(a, b, level, npix_band=False):
    """Every comparison above, in order; returns the transients' (x, y)
    of ``a``."""
    check_statuses(a, b)
    check_headers(a, b, level)
    check_masks(a, b)
    check_master_flat(a, b)
    check_images(a, b, level)
    check_difference_images(a, b)
    check_catalogs(a, b)
    return check_transients(a, b, npix_band)


# ---------------------------------------------------------- knob night
#
# The driver's optional calibration branches on ``tiny_night``: a static
# bad-pixel mask and a non-linearity file named relative to ``cal_dir``,
# three darks stacked into a master dark (``create_mdark``), the field
# grid's pointing check, and a granular resume of the second visit.

CAL_DIR = "CalFiles"
BPM_FILE = "bpm_q.fits"
NONLIN_FILE = "nonlin.npy"
NONLIN_FRAC = 0.02      # the .npy file's constant fractional correction
DARK_RATE = 0.5         # e-/s, the synthetic darks' dark current
FIELD_GRID = {42: (RA0, DEC0)}


def bpm_pixels(shape, nscatter):
    """(rows, columns) of a static mask's BAD pixels on a frame of
    ``shape``: the middle half of the column at a third of the width,
    and ``nscatter`` pixels drawn from seed 3."""
    H, W = shape
    rng = np.random.default_rng(3)
    col = np.arange(H // 4, 3 * H // 4)
    return (np.concatenate([col, rng.integers(0, H, nscatter)]),
            np.concatenate([np.full(col.size, W // 3),
                            rng.integers(0, W, nscatter)]))


def write_bpm(path, shape, nscatter):
    """The static mask of ``bpm_pixels`` as a uint8 FITS image."""
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.fits import Header, write_image
    bpm = np.zeros(shape, np.uint8)
    bpm[bpm_pixels(shape, nscatter)] = maskbits.BAD
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_image(path, bpm, Header())


def knob_settings(root):
    """The knob night's settings beyond ``tiny_night``'s (``create_ref``):
    the mask and the non-linearity file of ``tiny_knob_night``, named
    relative to ``root``/CAL_DIR, and the master dark."""
    return dict(cal_dir=os.path.join(root, CAL_DIR),
                bad_pixel_mask={"q": BPM_FILE}, correct_nonlin=True,
                nonlin_corr_file=NONLIN_FILE, create_mdark=True)


def tiny_knob_night(root):
    """``tiny_night`` under ``root``, three 60-s darks at 22:48 (seed 12,
    DARK_RATE) and, under ``root``/CAL_DIR, the static mask
    (``bpm_pixels`` with 40 scattered pixels) and the constant
    NONLIN_FRAC correction as (C, 3) coefficients.  Returns the raw
    files in the order the night reduces them (bias, flat, dark, the two
    visits) and the stars' truth."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.synth.observation import write_observation
    files, stars = tiny_night(root)
    rng = np.random.default_rng(12)
    mjd0 = iso2mjd("2026-03-01T22:48:00.000")
    darks = []
    for i in range(3):
        p = os.path.join(DataTree(root, "ML1").raw_dir(DATE),
                         f"ML1_{DATE}_22480{i}.fits")
        write_observation(p, TINY, rng, "dark", mjd_start=mjd0 + i * 1e-3,
                          dark_rate_e=DARK_RATE)
        darks.append(p)
    cal = os.path.join(root, CAL_DIR)
    write_bpm(os.path.join(cal, BPM_FILE), TINY.red_shape, 40)
    coeffs = np.zeros((TINY.n_chan, 3), np.float32)
    coeffs[:, 0] = NONLIN_FRAC
    np.save(os.path.join(cal, NONLIN_FILE), coeffs)
    return files[:6] + darks + files[6:], stars


def resume(pipe, path):
    """The granular resume of a reduced visit (raw ``path``), twice: its
    catalog deleted and its catalog stage run again from the published
    image (``trans_extract=False``).  Returns both FrameResults."""
    from blackbox_tpu_torch.orchestration.paths import base_name
    out = []
    for _ in range(2):
        cat, = glob.glob(os.path.join(pipe.tree.root, "**", base_name(path)
                                      + "_red_cat.fits"), recursive=True)
        os.remove(cat)
        out.append(pipe.process_file(path, trans_extract=False))
    return out


# the catalog columns the extraction alone gives; the others (RA, DEC
# and the magnitudes) take the WCS and the zeropoint that ``Pipeline``
# then solves on the host from these
EXTRACTED = ("NUMBER", "X_POS", "Y_POS", "XVAR_POS", "YVAR_POS",
             "ELONGATION", "FWHM", "CLASS_STAR", "FLAGS", "FLAGS_MASK",
             "BACKGROUND", "E_FLUX_APER", "E_FLUXERR_APER", "MAGERR_APER",
             "E_FLUX_AUTO", "E_FLUXERR_AUTO", "MAGERR_AUTO", "E_FLUX_OPT",
             "E_FLUXERR_OPT", "MAGERR_OPT", "SNR_OPT")


def check_resumed_catalog(pipe, cat_path):
    """A resumed visit's catalog (``cat_path``, written on the reuse
    path) against ``extract_catalog`` run again through ``pipe``'s
    context on its device, on the published image and mask beside it
    as ``Pipeline`` decodes them: every EXTRACTED column bit for bit.
    Returns the number of rows."""
    import torch
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.pipeline.catalogs import device_cat_to_columns
    from blackbox_tpu_torch.pipeline.reduce import extract_catalog
    stem = cat_path[:-len("_red_cat.fits")]
    sci, mask = (torch.as_tensor(np.asarray(read_rice(stem + ext)[0], dt),
                                 device=pipe.device)
                 for ext, dt in (("_red.fits.fz", np.float32),
                                 ("_mask.fits.fz", np.uint8)))
    with torch.inference_mode():
        cat = extract_catalog(pipe.ctx, sci, mask)["cat"]
    want = device_cat_to_columns(cat, None)
    got = table(cat_path)
    bad = [k for k in EXTRACTED
           if not np.array_equal(np.asarray(got[k]), want[k])]
    assert not bad, (cat_path, bad)
    return len(want["NUMBER"])


def check_knobs(run, resumes, shape):
    """The knob night's flags (``shape`` its frames'): BPM-F on the
    object and flat frames and the BAD bit at every pixel of the static
    mask in the object frames' masks, NONLIN-P on every
    frame the correction applies to, the master dark of three darks,
    RADECOFF, the first visit adopted as reference and the second
    subtracted, and both resumes through the published image."""
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.rice import read_rice
    res, root = run
    bpm = bpm_pixels(shape, 40)
    for r in res:
        h = r.header
        kind = str(h["IMAGETYP"]).strip()
        assert r.status == "reduced", r.error
        assert h["NONLIN-P"] is True, kind
        if kind in ("object", "flat"):
            assert h["BPM-F"] == BPM_FILE, kind
        if kind == "object":
            mask, = (p for p in r.products if p.endswith("_mask.fits.fz"))
            m = read_rice(mask)[0].astype(np.uint8)
            assert np.all(m[bpm] & maskbits.BAD), mask
            assert float(h["RADECOFF"]) < 5.0
    assert res[-2].header["REF-NEW"] is True
    h = res[-1].header
    assert h["TRANS-P"] is True and h["T-NTRANS"] >= 1
    mdark = os.path.join(root, "ML1", "masters", f"dark_{DATE}.fits.fz")
    mh = read_rice(mdark)[1]
    assert int(mh["NDARK"]) == 3, mh["NDARK"]
    for r in resumes:
        assert r.status == "reduced", r.error
        assert r.header["RED-REUSED"] is True
    return float(mh["MDMEAN"])


# -------------------------------------------------------------- co-add

COADD_SETTINGS = dict(nimages_min=3, limmag_target=30.0, seeing_max=10.0)


def tiny_visits(root, create_ref: bool):
    """Three visits of field 42 sharing one star field (seed 11: 3 bias,
    3 flat, 3 object frames of 40 stars), reduced file to file under
    ``root`` by the port's Pipeline on the CPU.  With ``create_ref`` the
    first visit is adopted as the field reference and the other two are
    subtracted against it.  Returns the FrameResults."""
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.pipeline.driver import Pipeline
    from blackbox_tpu_torch.synth.observation import night_of_observations
    rng = np.random.default_rng(11)
    files, truths, tree = night_of_observations(
        root, TINY, rng, date=DATE, nbias=3, nflat=3, nsci=3, nstars=40,
        ncosmics=10, trail=False, nsat=0, sky_e=300.0, ra_deg=RA0,
        dec_deg=DEC0)
    s = ReductionSettings(geometry=TINY, pixscale=PIXSCALE,
                          create_ref=create_ref, make_quicklooks=False)
    pipe = Pipeline(tree, "ML1", s, tiny_ctx(s),
                    ref_catalog=ref_catalog(truths[-1].stars, TINY.red_shape),
                    device="cpu")
    return [pipe.process_file(f) for f in files]


# ------------------------------------------- SSO and lost-pointing frames

LOST = (0.5, -0.3)      # deg, the lost visit's pointing error (RA, Dec)


def lost_pointing_visit(root, stars):
    """A third visit of ``tiny_night``'s field at 23:45 whose header
    points LOST degrees off (the stars where the first visit has them,
    its night's flat response), written into the raw tree under
    ``root``; the seeded astrometric solve cannot find it.  Returns its
    path."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.synth.generator import _vignette_flat
    from blackbox_tpu_torch.synth.observation import write_observation
    # the night's flat is tiny_night's first draw from its generator
    flat = _vignette_flat(TINY, np.random.default_rng(11))
    path = os.path.join(DataTree(root, "ML1").raw_dir(DATE),
                        f"ML1_{DATE}_234500.fits")
    write_observation(path, TINY, np.random.default_rng(5), "object",
                      mjd_start=iso2mjd("2026-03-01T23:45:00.000"),
                      nstars=0, ncosmics=4, trail=False, nsat=0,
                      sky_e=300.0, ra_deg=RA0 + LOST[0],
                      dec_deg=DEC0 + LOST[1], stars=stars, flat=flat)
    return path


def net_visit(root, stars, at="23:55:00"):
    """A further visit of ``tiny_night``'s field at ``at`` (UT, the same
    pixels whatever the time), pointed as the first, with the transient
    where the second has it (``stars`` plus TRANS, its night's flat
    response), written into the raw tree under ``root`` for the
    networks' run.  Returns its path."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.synth.generator import _vignette_flat
    from blackbox_tpu_torch.synth.observation import write_observation
    flat = _vignette_flat(TINY, np.random.default_rng(11))
    path = os.path.join(DataTree(root, "ML1").raw_dir(DATE),
                        f"ML1_{DATE}_{at.replace(':', '')}.fits")
    write_observation(path, TINY, np.random.default_rng(8), "object",
                      mjd_start=iso2mjd(f"2026-03-01T{at}.000"),
                      nstars=0, ncosmics=4, trail=False, nsat=0,
                      sky_e=300.0, ra_deg=RA0, dec_deg=DEC0,
                      stars=np.concatenate([stars, [[*TRANS, 3.0]]]),
                      flat=flat)
    return path


def quad_index(stars, shape):
    """A blind-solve quad index over the calibration stars of
    ``ref_catalog``, for quads of 18-108 arcsec (the TINY frame is 75 x
    180 arcsec)."""
    from blackbox_tpu_torch.astro.blindsolve import QuadIndex
    from blackbox_tpu_torch.astro.wcs import TanWCS
    wcs = TanWCS.simple(RA0, DEC0, PIXSCALE, shape)
    ra, dec = wcs.pix2sky(stars[:, 0], stars[:, 1])
    mag = ZP_TRUE - 2.5 * np.log10(stars[:, 2] / 60.0)
    return QuadIndex.build(ra, dec, mag, 0.005, 0.03)


def sso_elements_at(ra, dec, mjd, site, designation, delta_au=1.2):
    """Circular-orbit elements of an asteroid that the port's (and the
    JAX package's) ephemeris puts at (ra, dec) [deg] from ``site`` at
    UT ``mjd``, ``delta_au`` from the observer: the heliocentric
    position at the light-time-corrected epoch fixes the orbit's radius,
    plane (inclination 40 deg) and argument of latitude."""
    from blackbox_tpu_torch.sso import match as M
    mjd_tt = mjd + M.TT_MINUS_UT_DAY
    p_obs = (M.earth_heliocentric_j2000(mjd_tt)
             + M.observer_offset_ecliptic(mjd, site))
    ra, dec = np.radians(ra), np.radians(dec)
    xq, yq, zq = (np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                  np.sin(dec))
    ce, se = np.cos(M.OBLIQUITY), np.sin(M.OBLIQUITY)
    p = p_obs + delta_au * np.array([xq, ce * yq + se * zq,
                                     -se * yq + ce * zq])
    r = float(np.linalg.norm(p))
    incl = np.radians(40.0)
    su = p[2] / (r * np.sin(incl))
    u = np.arctan2(su, np.sqrt(1.0 - su * su))
    node = np.arctan2(p[1], p[0]) - np.arctan2(r * su * np.cos(incl),
                                               r * np.cos(u))
    return M.Elements(designation, a=r, e=0.0, incl=40.0,
                      node=float(np.degrees(node) % 360.0), argper=0.0,
                      M0=float(np.degrees(u) % 360.0),
                      epoch_mjd=mjd_tt - delta_au / M.C_AU_DAY)
