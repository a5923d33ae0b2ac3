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

import os

import numpy as np

SCORR_RTOL = 0.05
SCORR_ATOL = 3e-3

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


def check_headers(a, b, level):
    """Same keywords and flags; integer, boolean and string keywords
    equal (PC-NCAL but for ``clip_edge``); magnitudes within 1e-3 mag
    (plus ``clip_edge``); other floats within FLOAT_RTOL, plus the
    pixel atol in e-.  Raises naming every keyword that differs."""
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
            if k == "PC-ZPSTD":
                ok = abs(x - y) <= 1e-3 + dstd * max(x, y)
            elif isinstance(y, float) and unit.startswith("[mag]"):
                ok = abs(x - y) <= 1e-3 + dzp
            elif isinstance(y, float) and not isinstance(x, (bool, str)):
                atol = pixel_atol(level) if unit.startswith("[e-]") \
                    else 1e-12
                ok = abs(x - y) <= FLOAT_RTOL * max(abs(x), abs(y)) + atol
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


def check_transients(a, b):
    """T-NTRANS equal, peak pixels equal but for a near tie, the rest at
    the Scorr and flux tolerances; returns the (x, y) of ``a``'s
    transients, 0-based."""
    ha, hb = a[0][-1].header, b[0][-1].header
    assert ha["T-NTRANS"] == hb["T-NTRANS"] >= 1
    (tb, ta), = pairs(a, b, "_red_trans.fits")
    (sb, _), = pairs(a, b, "_Scorr.fits.fz")
    cb, ca = table(tb), table(ta)
    assert list(ca) == list(cb) and len(ca["NUMBER"]) == len(cb["NUMBER"])
    scorr, _ = decode(sb)
    ax, ay = (np.asarray(ca[k]) - 1 for k in ("X_PEAK", "Y_PEAK"))
    bx, by = (np.asarray(cb[k]) - 1 for k in ("X_PEAK", "Y_PEAK"))
    keep = np.setdiff1d(np.arange(len(ax)),
                        peak_ties((ax, ay), (bx, by), scorr))
    for k in ("X_PEAK", "Y_PEAK", "NUMBER", "NPIX_ZOGY"):
        assert np.array_equal(np.asarray(ca[k])[keep],
                              np.asarray(cb[k])[keep]), k
    x, y = (np.asarray(c["SNR_ZOGY"])[keep] for c in (ca, cb))
    assert np.all(np.abs(x - y) <= SCORR_ATOL + SCORR_RTOL * np.abs(y))
    for k in ("E_FLUX_ZOGY", "ELONG_ZOGY"):
        x, y = (np.asarray(c[k])[keep] for c in (ca, cb))
        assert np.all(np.abs(x - y) <= 1e-3 * np.abs(y) + 3e-3), k
    return ax, ay


def check_night(a, b, level):
    """Every comparison above, in order; returns the transients' (x, y)
    of ``a``."""
    check_statuses(a, b)
    check_headers(a, b, level)
    check_masks(a, b)
    check_master_flat(a, b)
    check_images(a, b, level)
    check_difference_images(a, b)
    check_catalogs(a, b)
    return check_transients(a, b)


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
