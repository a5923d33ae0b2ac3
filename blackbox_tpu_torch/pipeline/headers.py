"""Header engine: raw-keyword normalisation + product keyword contract.

Rebuild of the reference's header layer (set_header blackbox.py:5663-6291,
check_header1/2 5445-5658, verify_header 2893-3256): raw telescope
keywords are normalised (mid-exposure DATE-OBS, MJD, LST, airmass,
alt/az, sun/moon ephemerides), every calibration step stamps its
quantitative keys from the device stats dict, and a declarative dtype
contract validates product headers before shipping.
"""

from __future__ import annotations

import logging

import numpy as np

from blackbox_tpu_torch.io.fits import Header

log = logging.getLogger("blackbox_tpu")
from blackbox_tpu_torch.astro import time as at
from blackbox_tpu_torch.astro import ephem as eph
from blackbox_tpu_torch.astro.wcs import haversine


def check_header_basic(h, n_fields_max: int = 19999) -> list:
    """Pre-reduction sanity checks (reference check_header1, 5445-5528).

    Returns a list of failure strings (empty = pass).
    """
    problems = []
    for key in ("DATE-OBS", "EXPTIME", "FILTER", "IMAGETYP"):
        if key not in h:
            problems.append(f"missing required keyword {key}")
    imgtype = str(h.get("IMAGETYP", "")).lower()
    if imgtype == "object":
        obj = h.get("OBJECT")
        try:
            fid = int(obj)
            if not (1 <= fid <= n_fields_max):
                problems.append(f"field ID {fid} outside 1..{n_fields_max}")
        except (TypeError, ValueError):
            problems.append(f"OBJECT {obj!r} is not a field ID")
    if "EXPTIME" in h:
        try:
            # bias/dark frames carry EXPTIME 0 legitimately
            if float(h["EXPTIME"]) <= 0 and imgtype == "object":
                problems.append("non-positive EXPTIME")
        except (TypeError, ValueError):
            problems.append("EXPTIME not numeric")
    return problems


# ---- ML1 archival header repairs (table-driven) ----------------------
#
# The early MeerLICHT archive carries two known acquisition-software
# bugs that must be repaired before any keyword is consumed (reference
# blackbox.py:6128-6162 filter mapping, 5890-5907 RA/DEC reference bug).
# Each entry: (telescope, mjd_start, mjd_end, condition, action).

# Abot wrote the wrong filter wheel position: correct = map[recorded]
# (determined by PaulG, Oliver & Danielle; reference Redmine bug #281)
LEGACY_FILTER_MAP_ML1 = {"u": "q", "g": "r", "q": "i",
                         "r": "g", "i": "z", "z": "u"}

# epoch boundaries (MJD), derived from the reference's ISO timestamps
_MJD_FILT_TRANS0 = at.iso2mjd("2017-11-19T00:00:00")   # Abot-or-manual
_MJD_FILT_TRANS1 = at.iso2mjd("2018-02-24T23:59:59")
_MJD_FILT_ALL0 = at.iso2mjd("2018-02-25T00:00:00")     # all-Abot
_MJD_FILT_ALL1 = at.iso2mjd("2019-01-13T15:00:00")
_MJD_RADEC_FIX = at.iso2mjd("2019-02-09T00:00:00")     # RA/DEC off-by-one


def patch_legacy_header(h: Header, tel, mjd_obs: float) -> Header:
    """Repair archival ML1 keyword bugs in place (and return ``h``).

    Reference parity (blackbox.py:6128-6162):
    * some 2017 data recorded filter 'VR' for 'q';
    * data taken by the Abot scheduler between 2017-11-19 and
      2019-01-13T15:00 has the filter wheel mis-identified — during the
      transition window (until 2018-02-24) only frames with
      OBSERVER='abot' are remapped, afterwards all frames are.
    """
    if tel != "ML1":
        return h
    filt = str(h.get("FILTER", "")).strip()
    if filt == "VR":
        h["FILTER"] = ("q", "Filter (corrected)")
        filt = "q"
    in_transition = _MJD_FILT_TRANS0 <= mjd_obs <= _MJD_FILT_TRANS1
    in_all_abot = _MJD_FILT_ALL0 <= mjd_obs <= _MJD_FILT_ALL1
    by_abot = str(h.get("OBSERVER", "")).strip().lower() == "abot"
    if filt in LEGACY_FILTER_MAP_ML1 and (
            (in_transition and by_abot) or in_all_abot):
        h["FILTER"] = (LEGACY_FILTER_MAP_ML1[filt], "Filter (corrected)")
    return h


def legacy_radec_override(h: Header, tel, mjd_obs: float):
    """ICRS (ra, dec) repairing the early-ML1 pointing bug, or None.

    Until 2019-02-09 the ML1 RA/DEC keywords referred to the SUBSEQUENT
    image (reference blackbox.py:5890-5907) — except for manual
    sexagesimal entries, recognisable by the absence of RA-TEL/DEC-TEL.
    For affected frames the reference substitutes RA-REF/DEC-REF, which
    are already J2000/ICRS (RA-REF in hours, DEC-REF in degrees).
    """
    if (tel == "ML1" and mjd_obs < _MJD_RADEC_FIX
            and "RA-REF" in h and "DEC-REF" in h):
        # RA-REF is in HOURS in every format — the reference parses it
        # with Angle(..., unit=u.hour), which also scales a bare
        # decimal by 15 (unlike the mount RA keyword, whose decimal
        # form is degrees); _parse_angle only applies the hour scale to
        # sexagesimal strings, so scale decimals here
        ra_ref = h["RA-REF"]
        dec = _parse_angle(h["DEC-REF"], hours=False)
        try:
            return 15.0 * float(ra_ref), dec
        except (TypeError, ValueError):
            return _parse_angle(ra_ref, hours=True), dec
    return None


def set_header(h: Header, site, field_grid=None, tel=None) -> Header:
    """Normalise the raw header: times, coordinates, observability.

    site : (lat_deg, lon_deg_east, height_m)
    field_grid : optional dict field_id -> (ra, dec) for pointing checks
    tel : telescope id; enables archival repairs (patch_legacy_header)
    """
    lat, lon, height = site

    # mid-exposure time: GPS shutter times when present (reference
    # blackbox.py:5772-5814), else DATE-OBS + EXPTIME/2
    exptime = float(h.get("EXPTIME", 0.0))
    if "GPSSTART" in h and "GPSEND" in h:
        m0 = at.iso2mjd(str(h["GPSSTART"]))
        m1 = at.iso2mjd(str(h["GPSEND"]))
        mjd_mid = 0.5 * (m0 + m1)
        h["GPS-SHUT"] = (round((m1 - m0) * 86400.0 - exptime, 4),
                         "[s] GPS shutter overhead")
    else:
        mjd_mid = at.iso2mjd(str(h["DATE-OBS"])) + exptime / 172800.0
    h["DATE-OBS"] = (at.mjd2iso(mjd_mid - exptime / 172800.0),
                     "UTC start of exposure")
    h["MJD-OBS"] = (round(mjd_mid, 8), "[d] MJD mid-exposure")
    h["LST"] = (round(at.lst_deg(mjd_mid, lon) / 15.0, 6),
                "[h] local sidereal time mid-exposure")

    # archival keyword repairs (ML1 filter-mapping bug; no-op elsewhere)
    patch_legacy_header(h, tel, mjd_mid)

    # pointing: JNOW mount coordinates -> ICRS
    if "RA" in h and "DEC" in h:
        ra_tel = _parse_angle(h["RA"], hours=True)
        dec_tel = _parse_angle(h["DEC"], hours=False)
        ra_icrs, dec_icrs = at.jnow2icrs(ra_tel, dec_tel, mjd_mid)
        # early-ML1 off-by-one pointing: RA-REF/DEC-REF (already ICRS)
        # replace the mount coordinates (blackbox.py:5890-5907)
        fix = legacy_radec_override(h, tel, mjd_mid)
        if fix is not None:
            ra_icrs, dec_icrs = fix
        h["RA"] = (round(float(ra_icrs), 6), "[deg] telescope RA (ICRS)")
        h["DEC"] = (round(float(dec_icrs), 6), "[deg] telescope DEC (ICRS)")
        h["AIRMASS"] = (round(float(at.airmass(ra_icrs, dec_icrs, mjd_mid,
                                               lat, lon)), 4),
                        "airmass mid-exposure")
        h["ALTITUDE"] = (round(float(at.altitude_deg(
            ra_icrs, dec_icrs, mjd_mid, lat, lon)), 3), "[deg] altitude")
        h["AZIMUTH"] = (round(float(at.azimuth_deg(
            ra_icrs, dec_icrs, mjd_mid, lat, lon)), 3), "[deg] azimuth")

        if field_grid is not None and "OBJECT" in h:
            try:
                fra, fdec = field_grid[int(h["OBJECT"])]
                off = haversine(ra_icrs, dec_icrs, fra, fdec) * 60.0
                h["RADECOFF"] = (round(float(off), 3),
                                 "[arcmin] pointing offset vs field grid")
            except (KeyError, TypeError, ValueError):
                pass

    # tracking state: the TCS writes a string 'True'/'False'; normalise
    # to bool (reference blackbox.py:5745-5750) — buildref's selection
    # keeps only tracked frames
    if "ISTRACKI" in h:
        v = h["ISTRACKI"]
        h["ISTRACKI"] = (v if isinstance(v, bool)
                         else str(v).strip().lower() in
                         ("true", "t", "1", "yes"),
                         "Telescope is tracking")

    # ephemerides
    h["SUNALT"] = (round(float(eph.sun_altitude(mjd_mid, lat, lon)), 2),
                   "[deg] sun altitude")
    h["MOONALT"] = (round(float(eph.moon_altitude(mjd_mid, lat, lon)), 2),
                    "[deg] moon altitude")
    h["MOONILLU"] = (round(float(eph.moon_illumination(mjd_mid)), 3),
                     "moon illuminated fraction")
    if "RA" in h and "DEC" in h:
        mra, mdec = eph.moon_radec(mjd_mid)
        h["MOONDIST"] = (round(float(haversine(h["RA"], h["DEC"],
                                               mra, mdec)), 2),
                         "[deg] moon separation")
    return h


def _parse_angle(v, hours: bool) -> float:
    """'HH:MM:SS.s' / 'DD:MM:SS' / decimal degrees -> degrees."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    parts = s.replace("h", ":").replace("m", ":").replace("s", "").split(":")
    if len(parts) == 1:
        return float(s)
    sign = -1.0 if parts[0].strip().startswith("-") else 1.0
    vals = [abs(float(p)) for p in parts]
    deg = vals[0] + vals[1] / 60.0 + (vals[2] if len(vals) > 2 else 0) / 3600.0
    deg *= sign
    return deg * 15.0 if hours else deg


def stamp_calibration(h: Header, stats: dict, gains, pixscale: float,
                      exptime: float) -> Header:
    """Write the per-channel + frame-level calibration keywords."""
    g = np.asarray(gains)
    C = len(g)
    for c in range(C):
        h[f"GAIN{c + 1}"] = (round(float(g[c]), 3),
                             f"[e-/ADU] channel {c + 1} gain")
    h["GAIN"] = (round(float(np.mean(g)), 3), "[e-/ADU] average gain")

    biasm = np.asarray(stats["biasm"])
    rdn = np.asarray(stats["rdn"])
    for c in range(C):
        h[f"BIASM{c + 1}"] = (round(float(biasm[c]), 2),
                              f"[e-] channel {c + 1} mean vertical overscan")
    for c in range(C):
        h[f"RDN{c + 1}"] = (round(float(rdn[c]), 3),
                            f"[e-] channel {c + 1} sigma vertical overscan")
    h["BIASMEAN"] = (round(float(stats["biasmean"]), 2),
                     "[e-] average channel bias level")
    h["RDNOISE"] = (round(float(stats["rdnoise"]), 3),
                    "[e-] average channel read noise")
    vfit_ok = np.asarray(stats.get("vfit_ok", np.ones(C, bool)))
    for c in range(C):
        h[f"VFITOK{c + 1}"] = (bool(vfit_ok[c]),
                               f"channel {c + 1} vert. overscan fit ok?")

    if "satlev" in stats:
        satlev = np.asarray(stats["satlev"])
        for c in range(C):
            h[f"SATLEV{c + 1}"] = (round(float(satlev[c]), 1),
                                   f"[e-] channel {c + 1} saturation")
        h["SATURATE"] = (round(float(stats["saturate"]), 1),
                         "[e-] mean saturation threshold")
    if "nobj_sat" in stats:
        h["NOBJ-SAT"] = (int(stats["nobj_sat"]),
                         "number of saturated objects")
    if "ncosmics" in stats:
        rate = float(stats["ncosmics"]) / max(exptime, 1e-9)
        h["NCOSMICS"] = (round(rate, 3),
                         "[/s] number of cosmic rays identified")
    if "nsats" in stats:
        h["NSATS"] = (int(stats["nsats"]), "number of satellite trails")
    if "n_infnan" in stats:
        h["N-INFNAN"] = (int(stats["n_infnan"]),
                         "number of infinite/NaN pixels in raw frame")

    # mask bit counts (reference mask_header blackbox.py:4601-4620)
    from blackbox_tpu_torch.core import maskbits
    text = {"bad": "BP", "edge": "EP", "saturated": "SP",
            "saturated-connected": "SCP", "satellite": "STP",
            "cosmic": "CRP", "crosstalk": "XTP"}
    for name, tag in text.items():
        key = f"n_{name}"
        if key in stats:
            h[f"M-{tag}"] = (True, f"{name} pixels included in mask?")
            h[f"M-{tag}VAL"] = (maskbits.BITS[name],
                                f"mask value of {name} pixels")
            h[f"M-{tag}NUM"] = (int(stats[key]),
                                f"number of {name} pixels")
    return h


def stamp_flatstats(h: Header, fs: dict) -> Header:
    """Write the flat-field statistics keyword set.

    Keyword contract of the reference's ``get_flatstats``
    (reference blackbox.py:3661-3820): NORMSEC medians, full-image
    stats, per-channel FLATM/S/RS, and the subimage-grid vignetting
    metrics RDIF-MAX / RSTD-MAX.
    """
    def num(v, nd=4):
        x = float(np.asarray(v))
        return round(x, nd) if np.isfinite(x) else "None"

    h["MEDSEC"] = (num(fs["medsec"], 2), "[e-] median flat over STATSEC")
    h["STDSEC"] = (num(fs["stdsec"], 2), "[e-] sigma (STD) flat over STATSEC")
    h["RSTDSEC"] = (num(fs["rstdsec"], 5), "relative sigma (STD) flat "
                    "over STATSEC")
    h["FLATMED"] = (num(fs["flatmed"], 2), "[e-] median flat")
    h["FLATSTD"] = (num(fs["flatstd"], 2), "[e-] sigma (STD) flat")
    h["FLATRSTD"] = (num(fs["flatrstd"], 5), "relative sigma (STD) flat")
    flatm = np.asarray(fs["flatm"])
    flats = np.asarray(fs["flats"])
    flatrs = np.asarray(fs["flatrs"])
    for c in range(len(flatm)):
        h[f"FLATM{c + 1}"] = (num(flatm[c], 2),
                              f"[e-] channel {c + 1} median flat")
    for c in range(len(flats)):
        h[f"FLATS{c + 1}"] = (num(flats[c], 2),
                              f"[e-] channel {c + 1} sigma (STD) flat")
    for c in range(len(flatrs)):
        h[f"FLATRS{c + 1}"] = (num(flatrs[c], 5),
                               f"channel {c + 1} relative sigma (STD) flat")
    h["NSUBSTOT"] = (int(fs["nsubstot"]),
                     "total number of subimages in grid")
    h["NSUBS"] = (int(fs["nsubs"]),
                  "number of interior subimages used")
    h["RDIF-MAX"] = (num(fs["rdif_max"], 5),
                     "max. relative median difference between subimages")
    h["RSTD-MAX"] = (num(fs["rstd_max"], 5),
                     "max. relative sigma (STD) of subimages")
    return h


def stamp_master(h: Header, imgtype: str, stats: dict) -> Header:
    """Write the master-frame keyword set.

    Contract of the reference's ``master_prep`` header section
    (reference blackbox.py:5076-5231): NBIAS/NDARK/NFLAT frame
    counts, master mean/STD overall and per channel (MBIASM/MBRDN,
    MDARKM/MDRDN), and the flat channel gain-correction factors
    GAINCF1..16.
    """
    def num(v, nd=4):
        x = float(np.asarray(v))
        return round(x, nd) if np.isfinite(x) else "None"

    if imgtype == "bias":
        h["NBIAS"] = (int(stats["nmbias"]),
                      "number of bias frames combined")
        mean = np.asarray(stats["mbias_chan_mean"])
        std = np.asarray(stats["mbias_chan_std"])
        h["MBMEAN"] = (num(stats["mbias_mean"], 3),
                       "[e-] mean master bias")
        h["MBRDN"] = (num(stats["mbias_std"], 3),
                      "[e-] sigma (STD) master bias")
        for c in range(len(mean)):
            h[f"MBIASM{c + 1}"] = (num(mean[c], 3),
                                   f"[e-] channel {c + 1} mean master bias")
        for c in range(len(std)):
            h[f"MBRDN{c + 1}"] = (num(std[c], 3),
                                  f"[e-] channel {c + 1} sigma (STD) "
                                  "master bias")
    elif imgtype == "dark":
        h["NDARK"] = (int(stats["nmdark"]),
                      "number of dark frames combined")
        mean = np.asarray(stats["mdark_chan_mean"])
        std = np.asarray(stats["mdark_chan_std"])
        h["MDMEAN"] = (num(float(np.mean(mean)), 4),
                       "[e-/s] mean master dark")
        h["MDRDN"] = (num(float(np.mean(std)), 4),
                      "[e-/s] sigma (STD) master dark")
        for c in range(len(mean)):
            h[f"MDARKM{c + 1}"] = (num(mean[c], 4),
                                   f"[e-/s] channel {c + 1} mean master dark")
        for c in range(len(std)):
            h[f"MDRDN{c + 1}"] = (num(std[c], 4),
                                  f"[e-/s] channel {c + 1} sigma (STD) "
                                  "master dark")
    elif imgtype == "flat":
        h["NFLAT"] = (int(stats["nmflat"]),
                      "number of flat frames combined")
        gaincf = np.asarray(stats["gaincf"])
        for c in range(len(gaincf)):
            h[f"GAINCF{c + 1}"] = (num(gaincf[c], 5),
                                   f"channel {c + 1} gain correction factor")
    return h


def stamp_extraction(h: Header, stats: dict, pixscale: float) -> Header:
    h["NOBJECTS"] = (int(stats["nobjects"]), "number of detected sources")
    h["S-SEEING"] = (round(float(stats["s_seeing_pix"]) * pixscale, 3),
                     "[arcsec] seeing (median FWHM)")
    h["S-SEEPIX"] = (round(float(stats["s_seeing_pix"]), 3),
                     "[pix] seeing (median FWHM)")
    if "s_seestd_pix" in stats:
        h["S-SEESTD"] = (round(float(stats["s_seestd_pix"])
                               * pixscale, 3), "[arcsec] seeing STD")
    if "s_elong" in stats:
        h["S-ELONG"] = (round(float(stats["s_elong"]), 4),
                        "median elongation (A/B)")
    if "s_elostd" in stats:
        h["S-ELOSTD"] = (round(float(stats["s_elostd"]), 4),
                         "elongation STD")
    h["S-BKG"] = (round(float(stats["bkg_median"]), 2),
                  "[e-] median background")
    h["S-BKGSTD"] = (round(float(stats["bkg_std"]), 2),
                     "[e-] background STD")
    return h


# ---- product header contract (verify_header equivalent) -----------------
#
# Mirrors the reference's ~290-entry dtype/None dictionary
# (blackbox.py:2893-3256) with its semantics: entries marked required
# (the reference's DB flag) HARD-FAIL when missing or None-but-not-
# allowed; dtype mismatches and missing optional keys are warnings.
# ``required`` is adapted to the keywords THIS pipeline guarantees.
#
# (key, dtype, required, none_ok)

_RAW_CONTRACT = [
    ("SIMPLE", bool, 0, 1), ("BITPIX", int, 0, 1), ("NAXIS", int, 0, 1),
    ("NAXIS1", int, 0, 1), ("NAXIS2", int, 0, 1), ("BUNIT", str, 0, 1),
    ("CCD-AMP", str, 0, 1), ("SET-TEMP", float, 0, 1),
    ("CCD-TEMP", float, 0, 1), ("XBINNING", int, 0, 1),
    ("YBINNING", int, 0, 1), ("ALTITUDE", float, 0, 1),
    ("AZIMUTH", float, 0, 1), ("DOMEAZ", float, 0, 1),
    ("RADESYS", str, 0, 1), ("EPOCH", float, 0, 1),
    ("RA", float, 1, 0), ("RA-REF", str, 0, 1), ("RA-TEL", float, 0, 1),
    ("DEC", float, 1, 0), ("DEC-REF", str, 0, 1),
    ("DEC-TEL", float, 0, 1), ("HA", float, 0, 0),
    ("FLIPSTAT", str, 0, 1), ("EXPTIME", float, 1, 0),
    ("ISTRACKI", bool, 0, 1), ("ACQSTART", str, 0, 0),
    ("ACQEND", str, 0, 1), ("GPSSTART", str, 0, 1),
    ("GPSEND", str, 0, 1), ("GPS-SHUT", float, 0, 1),
    ("DATE-OBS", str, 1, 0), ("MJD-OBS", float, 1, 0),
    ("LST", float, 1, 0), ("UTC", float, 0, 0), ("TIMESYS", str, 0, 1),
    ("ORIGIN", str, 0, 1), ("MPC-CODE", str, 0, 0),
    ("TELESCOP", str, 1, 0), ("CL-BASE", float, 0, 1),
    ("RH-MAST", float, 0, 1), ("RH-DOME", float, 0, 1),
    ("PRESSURE", float, 0, 1), ("T-PIER", float, 0, 1),
    ("T-DOME", float, 0, 1), ("WINDAVE", float, 0, 1),
    ("WINDGUST", float, 0, 1), ("WINDDIR", float, 0, 1),
    ("SITELAT", float, 0, 1), ("SITELONG", float, 0, 1),
    ("ELEVATIO", int, 0, 1), ("WEATIME", str, 0, 1),
    ("FILTER", str, 1, 0), ("FILTERID", str, 0, 1),
    ("CCD-ID", str, 0, 1), ("CONTROLL", str, 0, 1),
    ("DETSPEED", int, 0, 1), ("CCD-NW", int, 0, 1),
    ("CCD-NH", int, 0, 1), ("INSTRUME", str, 0, 1),
    ("FOCUSPOS", int, 0, 1), ("IMAGETYP", str, 1, 1),
    ("OBJECT", str, 1, 0), ("AIRMASS", float, 1, 0),
    ("ORIGFILE", str, 0, 0), ("OBSERVER", str, 0, 1),
    ("PROGNAME", str, 0, 1), ("PROGID", str, 0, 1),
    ("GUIDERST", str, 0, 1), ("GUIDERFQ", float, 0, 1),
    ("TRAKTIME", float, 0, 1), ("ADCX", float, 0, 1),
    ("ADCY", float, 0, 1),
]

_FULL_CONTRACT = [
    ("BB-V", str, 0, 0), ("BB-START", str, 0, 0), ("KW-V", str, 0, 0),
    ("LOG", str, 0, 1), ("LOG-IMA", str, 0, 1),
    ("N-INFNAN", int, 1, 1),
    ("XTALK-P", bool, 1, 0), ("XTALK-F", str, 0, 1),
    ("NONLIN-P", bool, 1, 0), ("NONLIN-F", str, 0, 1),
    ("GAIN-P", bool, 1, 0), ("GAIN", float, 1, 1),
    ("OS-P", bool, 1, 0),
    ("BIASMEAN", float, 1, 1), ("RDNOISE", float, 1, 1),
    ("MBIAS-P", bool, 1, 0), ("MBIAS-F", str, 0, 1),
    ("MB-NDAYS", float, 0, 1),
    ("SATURATE", float, 1, 1), ("NOBJ-SAT", int, 1, 1),
    ("MFLAT-P", bool, 1, 0), ("MFLAT-F", str, 0, 1),
    ("MF-NDAYS", float, 0, 1),
    ("MFRING-P", bool, 0, 0), ("MFRING-F", str, 0, 1),
    ("FRRATIO", float, 0, 1),
    ("COSMIC-P", bool, 1, 0), ("NCOSMICS", float, 1, 1),
    ("SAT-P", bool, 1, 0), ("NSATS", int, 1, 1),
    ("REDFILE", str, 0, 1), ("MASKFILE", str, 0, 1),
    ("S-P", bool, 1, 0), ("S-V", str, 0, 1), ("S-NOBJ", int, 0, 1),
    ("S-FWHM", float, 0, 1), ("S-FWSTD", float, 0, 1),
    ("S-SEEING", float, 1, 1), ("S-SEESTD", float, 0, 1),
    ("S-ELONG", float, 0, 1), ("S-ELOSTD", float, 0, 1),
    ("S-BKG", float, 1, 1), ("S-BKGSTD", float, 1, 1),
    ("S-VIGNET", int, 0, 1),
    ("BKG-CORR", bool, 0, 1), ("BKG-CHI2", float, 0, 1),
    ("BKG-FDEG", int, 0, 1), ("BKG-FC0", float, 0, 1),
    ("A-P", bool, 1, 0), ("A-V", str, 0, 1), ("A-INDEX", str, 0, 1),
    ("A-PSCALE", float, 0, 1), ("A-PSCALX", float, 0, 1),
    ("A-PSCALY", float, 0, 1), ("A-ROT", float, 0, 1),
    ("A-ROTX", float, 0, 1), ("A-ROTY", float, 0, 1),
    ("A-CAT-F", str, 0, 1), ("A-NAST", int, 0, 1),
    ("A-TNAST", int, 0, 1), ("A-NAMAX", int, 0, 1),
    ("A-DRA", float, 0, 1), ("A-DRASTD", float, 0, 1),
    ("A-DDEC", float, 0, 1), ("A-DDESTD", float, 0, 1),
    ("A-NA-OFF", int, 0, 1), ("A-RMS", float, 0, 1),
    ("A-BLIND", bool, 0, 1),
    ("PSF-P", bool, 1, 0), ("PSF-V", str, 0, 1),
    ("PSF-RAD", float, 0, 1), ("PSF-SIZE", int, 0, 1),
    ("PSF-FRAC", float, 0, 1), ("PSF-SAMP", float, 0, 1),
    ("PSF-CFGS", int, 0, 1), ("PSF-NOBJ", int, 0, 1),
    ("PSF-FIX", bool, 0, 1), ("PSF-PLDG", int, 0, 1),
    ("PSF-CHI2", float, 0, 1), ("PSF-FWHM", float, 0, 1),
    ("PSF-SEE", float, 0, 1),
    ("PC-P", bool, 1, 0), ("PC-CAT-F", str, 0, 1),
    ("PC-NCAL", int, 0, 1), ("PC-TNCAL", int, 0, 1),
    ("PC-FNCAL", int, 0, 1), ("PC-NCMAX", int, 0, 1),
    ("PC-NCMIN", int, 0, 1), ("PC-ZPCHN", bool, 0, 1),
    ("PC-MZPD", float, 0, 1), ("PC-MZPS", float, 0, 1),
    ("PC-MZPE", float, 0, 1), ("PC-ZPDEF", bool, 0, 1),
    ("PC-ZP", float, 0, 1), ("PC-ZPSTD", float, 0, 1),
    ("PC-ZPERR", float, 0, 1), ("PC-EXTCO", float, 0, 1),
    ("AIRMASSC", float, 0, 1), ("RA-CNTR", float, 0, 1),
    ("DEC-CNTR", float, 0, 1), ("AZ-CNTR", float, 0, 1),
    ("ALT-CNTR", float, 0, 1), ("BJD-OBS", float, 0, 1),
    ("NSIGMA", int, 0, 1), ("LIMEFLUX", float, 0, 1),
    ("LIMFNU", float, 0, 1), ("LIMMAG", float, 0, 1),
    ("NOBJECTS", int, 1, 1), ("NGAIA", int, 0, 1),
    ("MAG-SAT", float, 0, 1), ("RADECOFF", float, 0, 1),
    ("RAOFF", float, 0, 1), ("DECOFF", float, 0, 1),
    ("FORMAT-P", bool, 0, 1), ("DUMCAT", bool, 1, 0),
    ("QC-FLAG", str, 1, 0), ("DATEFILE", str, 0, 1),
    ("MASK-P", bool, 1, 0), ("BPM-F", str, 0, 1),
]

_TRANS_CONTRACT = [
    ("SWARP-P", bool, 0, 0), ("SWARP-V", str, 0, 1),
    ("Z-REF", str, 0, 1), ("Z-DXYLOC", bool, 0, 1),
    ("Z-DX", float, 0, 1), ("Z-DY", float, 0, 1),
    ("Z-DXSTD", float, 0, 1), ("Z-DYSTD", float, 0, 1),
    ("Z-DXRMS", float, 0, 1), ("Z-DYRMS", float, 0, 1),
    ("Z-FNRLOC", bool, 0, 1), ("Z-FNR", float, 0, 1),
    ("Z-FNRSTD", float, 0, 1), ("Z-FNRERR", float, 0, 1),
    ("Z-FRATIO", float, 0, 1), ("Z-FRSTD", float, 0, 1),
    ("Z-P", bool, 0, 0), ("Z-V", str, 0, 1), ("Z-SIZE", int, 0, 1),
    ("Z-BSIZE", int, 0, 1), ("Z-SCMED", float, 0, 1),
    ("Z-SCSTD", float, 0, 1), ("Z-FPEMED", float, 0, 1),
    ("Z-FPESTD", float, 0, 1),
    ("T-NSIGMA", int, 0, 1), ("T-LFLUX", float, 0, 1),
    ("T-NTRANS", int, 1, 1), ("T-FTRANS", float, 0, 1),
    ("T-LFNU", float, 0, 1), ("T-LMAG", float, 0, 1),
    ("T-NFAKE", int, 0, 1), ("T-FAKESN", float, 0, 1),
    ("MC-P", bool, 0, 0), ("MC-V", str, 0, 1), ("MC-MODEL", str, 0, 1),
    ("TDUMCAT", bool, 0, 0), ("TQC-FLAG", str, 1, 0),
]


def _per_channel_contract(nchan: int = 16) -> list:
    out = []
    for c in range(1, nchan + 1):
        out += [(f"GAIN{c}", float, 0, 1), (f"BIASM{c}", float, 0, 1),
                (f"RDN{c}", float, 0, 1), (f"VFITOK{c}", bool, 0, 1),
                (f"SATLEV{c}", float, 0, 1),
                (f"BIAS{c}A0", float, 0, 1), (f"BIAS{c}A1", float, 0, 1),
                (f"BKG-CF{c}", float, 0, 1)]
    return out


HEADER_CONTRACT = {
    "raw": {k: (dt, bool(req), bool(n))
            for k, dt, req, n in _RAW_CONTRACT},
    "full": {k: (dt, bool(req), bool(n))
             for k, dt, req, n in _FULL_CONTRACT
             + _per_channel_contract()},
    "trans": {k: (dt, bool(req), bool(n))
              for k, dt, req, n in _TRANS_CONTRACT},
}


def verify_header(h, htype: str = "full", strict: bool = False):
    """Validate a product header against the dtype contract.

    Returns a list of ERROR strings: required keywords that are missing
    or carry a disallowed None (reference verify_header raises for its
    DB keys, blackbox.py:3235-3248).  dtype mismatches and missing
    optional keys are logged as warnings (reference behaviour), or
    included in the error list when ``strict``.
    """
    errors, warnings = [], []
    for key, (dtype, required, none_ok) in \
            HEADER_CONTRACT.get(htype, {}).items():
        if key not in h:
            (errors if required else warnings).append(
                f"{htype}: missing {key}")
            continue
        v = h[key]
        if v is None or (isinstance(v, str) and v == "None"):
            if not none_ok:
                errors.append(f"{htype}: {key} is None")
            continue
        ok = isinstance(v, dtype)
        if dtype is float:
            ok = isinstance(v, (float, int)) and not isinstance(v, bool)
        elif dtype is int:
            ok = isinstance(v, int) and not isinstance(v, bool)
        elif dtype is bool:
            ok = isinstance(v, bool)
        if not ok:
            warnings.append(
                f"{htype}: {key} has type {type(v).__name__}, "
                f"expected {dtype.__name__}")
    for w in warnings:
        log.debug("verify_header: %s", w)
    return errors + warnings if strict else errors
