"""QC range tables.

Structured like the reference's ``Settings/set_qc.py`` qc_range dictionary
(telescope-keyed, filter-keyed sub-ranges, graded green/yellow/orange
windows, ``sigma``/``key`` val_types) but maintained as framework data and
generated from compact schema helpers instead of 1300 literal lines.  The
surface mirrors the reference contract (key_types full/trans/flat/mbias/
mflat/ref/raw); the graded windows are tuned to this framework's pipeline.

Each entry: {default, val_type, val_range, key_type, pos, comment}.
"""

from __future__ import annotations

FILTERS = ("u", "g", "q", "r", "i", "z")


def _e(default, val_type, val_range, key_type, comment="", pos=False):
    return {"default": default, "val_type": val_type,
            "val_range": val_range, "key_type": key_type,
            "pos": pos, "comment": comment}


def _skip(key_type, comment="", default=None):
    return _e(default, "skip", None, key_type, comment)


def _per_filter(windows: dict) -> dict:
    """{filter: ranges} with every survey filter present (the engine
    red-flags unknown filters, so the table must be complete)."""
    assert set(windows) == set(FILTERS), sorted(windows)
    return windows


_BASE = {
    # ---- raw header contract ----
    # the reference has no EXPTIME entry (bias frames carry 0 s); kept
    # as an explicit skip for documentation
    "EXPTIME": _skip("raw", "[s] exposure time"),
    "ISTRACKI": _e(False, "bool", [True], "full", "Telescope is tracking"),
    "GPS-SHUT": _e(None, "min_max", [(0.0, 0.2), (-1.0, 1.0),
                                     (-1e3, 1e3)], "full",
                   "[s] shutter overhead (GPSEND-GPSSTART)-EXPTIME"),

    # ---- processing-step flags ('full'; reference set_qc.py:104-129)
    # required steps are red when absent; optional (settings-gated)
    # steps grade yellow when off so the flag still surfaces
    "OS-P": _e(False, "bool", [True], "full", "corrected for overscan?"),
    "GAIN-P": _e(False, "bool", [True], "full", "corrected for gain?"),
    "MASK-P": _e(False, "bool", [True], "full", "initial mask built?"),
    "COSMIC-P": _e(False, "bool", [True], "full",
                   "corrected for cosmic rays?"),
    "XTALK-P": _e(False, "bool", [True, False], "full",
                  "corrected for crosstalk?"),
    "NONLIN-P": _e(False, "bool", [False, True], "full",
                   "corrected for non-linearity?"),
    "MBIAS-P": _e(False, "bool", [True, False], "full",
                  "corrected for master bias?"),
    "MBIAS-F": _skip("full", "name of master bias applied"),
    "MB-NDAYS": _e(None, "min_max", [(0, 3), (0, 7), (0, 62)], "full",
                   "[days] age of master bias", pos=True),
    "MDARK-P": _e(False, "bool", [False, True], "full",
                  "corrected for master dark?"),
    "MDARK-F": _skip("full", "name of master dark applied"),
    "MFLAT-P": _e(False, "bool", [True], "full",
                  "corrected for master flat?"),
    "MFLAT-F": _skip("full", "name of master flat applied"),
    "MF-NDAYS": _e(None, "min_max", [(0, 7), (0, 14), (0, 62)], "full",
                   "[days] age of master flat", pos=True),
    "MFRING-P": _skip("full", "corrected for master fringe map?",
                      default=False),
    "MFRING-F": _skip("full", "name of master fringe map applied"),
    "SAT-P": _skip("full", "processed for satellite trails?",
                   default=False),
    "ASTA-P": _skip("full", "U-Net trail segmentation applied?",
                    default=False),
    "S-P": _e(False, "bool", [True], "full",
              "source extraction succeeded?"),
    "A-P": _e(False, "bool", [True], "full", "astrometry solved?"),
    "PSF-P": _e(False, "bool", [True], "full", "PSF fit succeeded?"),
    "PC-P": _e(False, "bool", [True], "full",
               "photometric calibration succeeded?"),
    "TRANS-P": _skip("full", "transients extracted?", default=False),

    # ---- detector calibration ('full') ----
    "RDNOISE": _e(None, "min_max", [(5, 15), (3, 20), (2, 30)], "full",
                  "[e-] average channel read noise", pos=True),
    "BIASMEAN": _e(None, "min_max", [(3000, 25000), (1000, 35000),
                                     (0, 60000)], "full",
                   "[e-] average channel bias level", pos=True),
    "NCOSMICS": _e(None, "min_max", [(0, 50), (0, 200), (0, 2000)],
                   "full", "[/s] cosmic-ray rate", pos=True),
    "NSATS": _e(None, "min_max", [(0, 5), (0, 10), (0, 30)], "full",
                "number of satellite trails", pos=True),
    "SATURATE": _e(None, "min_max", [(30000, 200000)], "full",
                   "[e-] mean saturation level", pos=True),
    "NOBJ-SAT": _e(None, "min_max", [(0, 1000), (0, 5000), (0, 50000)],
                   "full", "number of saturated objects", pos=True),
    "N-INFNAN": _e(None, "min_max", [(0, 0), (1, 10), (11, 1e6)],
                   "full", "number of infinite/NaN pixels", pos=True),

    # ---- source extraction ('full') ----
    "S-SEEING": _e(None, "min_max", _per_filter(
        {f: [(0.5, 4.0), (0.3, 6.0), (0.2, 10.0)] for f in FILTERS}),
        "full", "[arcsec] seeing", pos=True),
    "S-SEESTD": _e(None, "min_max", [(0, 0.5), (0, 1.5), (0, 10)],
                   "full", "[arcsec] seeing STD", pos=True),
    "S-ELONG": _e(None, "sigma", [(1.1, 0.2)], "full",
                  "median elongation (A/B)", pos=True),
    "S-ELOSTD": _e(None, "min_max", [(0, 0.3), (0, 0.8), (0, 10)],
                   "full", "elongation STD", pos=True),
    "NOBJECTS": _e(0, "min_max", [(100, 10**7), (10, 10**7), (0, 10**7)],
                   "full", "number of detected sources", pos=True),
    "S-NOBJ": _skip("full", "number of objects (SExtractor alias)"),
    "S-BKG": _e(None, "min_max", [(0, 5000), (0, 20000), (-100, 100000)],
                "full", "[e-] median background"),
    "S-BKGSTD": _e(None, "min_max", [(0, 500), (0, 2000), (0, 100000)],
                   "full", "[e-] background STD", pos=True),
    "NSIGMA": _skip("full", "[sigma] source detection threshold"),

    # ---- astrometry ('full') ----
    "A-NAST": _e(None, "min_max", [(20, 10**7), (8, 10**7), (3, 10**7)],
                 "full", "astrometric matches", pos=True),
    # wide windows: the per-axis A-DRA/A-DDEC sigmas carry the tight
    # astrometric quality signal; A-RMS must stay sane across pixel
    # scales (the TINY test geometry runs at 20 arcsec/pix)
    "A-RMS": _e(None, "min_max", [(0, 1.5), (0, 3.0), (0, 15.0)], "full",
                "[arcsec] astrometric rms", pos=True),
    "A-PSCALE": _e(None, "exp_frac", [(0.5642, 0.005), (0.5642, 0.02),
                                      (0.5642, 0.1)], "full",
                   "[arcsec/pix] solved pixel scale", pos=True),
    "A-ROT": _e(None, "min_max", [(-1.0, 1.0), (-5, 5), (-360, 360)],
                "full", "[deg] solved rotation vs N-up"),
    "A-DRA": _e(None, "sigma", [(0.0, 0.05)], "full",
                "[arcsec] dRA median offset to catalog"),
    "A-DRASTD": _e(None, "sigma", [(0.06, 0.04)], "full",
                   "[arcsec] dRA STD", pos=True),
    "A-DDEC": _e(None, "sigma", [(0.0, 0.05)], "full",
                 "[arcsec] dDEC median offset to catalog"),
    "A-DDESTD": _e(None, "sigma", [(0.06, 0.04)], "full",
                   "[arcsec] dDEC STD", pos=True),
    "A-CAT-F": _skip("full", "astrometric reference catalog"),
    "RADECOFF": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10.0)],
                   "full", "[arcmin] offset vs field grid", pos=True),
    "RA-CNTR": _skip("full", "[deg] RA at image centre"),
    "DEC-CNTR": _skip("full", "[deg] DEC at image centre"),
    "AIRMASS": _skip("full", "airmass mid-exposure"),
    "AIRMASSC": _skip("full", "airmass at image centre"),
    "BJD-OBS": _skip("full", "[d] barycentric Julian date"),

    # ---- photometric calibration ('full') ----
    "LIMMAG": _e(None, "min_max", _per_filter(
        {"u": [(18.5, 23.5), (17, 24), (12, 25)],
         "g": [(19.5, 24.5), (18, 25), (12, 26)],
         "q": [(19.5, 24.5), (18, 25), (12, 26)],
         "r": [(19.0, 24.0), (17.5, 25), (12, 26)],
         "i": [(18.5, 23.5), (17, 24), (12, 25)],
         "z": [(17.5, 22.5), (16, 23), (12, 24)]}),
        "full", "[mag] 5-sigma limiting magnitude", pos=True),
    "PC-ZP": _e(None, "min_max", _per_filter(
        {"u": [(21.5, 23.3), (21, 23.8), (19, 25)],
         "g": [(22.5, 24.3), (22, 24.8), (20, 26)],
         "q": [(22.8, 24.6), (22.3, 25.1), (20, 26)],
         "r": [(22.0, 23.8), (21.5, 24.3), (20, 26)],
         "i": [(21.4, 23.2), (20.9, 23.7), (19, 25)],
         "z": [(20.5, 22.3), (20, 22.8), (18, 24)]}),
        "full", "[mag] photometric zeropoint", pos=True),
    "PC-ZPSTD": _e(None, "min_max", [(0, 0.08), (0, 0.15), (0, 0.5)],
                   "full", "[mag] zeropoint STD over stars", pos=True),
    "PC-ZPERR": _e(None, "min_max", [(0, 0.02), (0, 0.07), (0, 1.0)],
                   "full", "[mag] zeropoint error of the mean", pos=True),
    "PC-NCAL": _e(None, "min_max", [(8, 10**7), (4, 10**7), (1, 10**7)],
                  "full", "number of calibration stars", pos=True),
    "PC-MZPS": _skip("full", "[mag] zeropoint STD over subimages"),
    # scales with the star-to-star scatter (reference set_qc.py:334)
    "PC-MZPD": _e(None, "key",
                  [(0, "0.00 + 5*header['PC-ZPSTD']"),
                   (0, "0.02 + 5*header['PC-ZPSTD']"),
                   (0, "0.05 + 5*header['PC-ZPSTD']")], "full",
                  "[mag] max zeropoint difference between subimages",
                  pos=True),
    "PC-EXTCO": _skip("full", "[mag/airmass] extinction coefficient"),
    "PC-CAT-F": _skip("full", "photometric reference catalog"),

    # ---- PSF ('full') ----
    "PSF-NOBJ": _e(None, "min_max", [(6, 10**7), (3, 10**7), (1, 10**7)],
                   "full", "stars used in PSF fit", pos=True),
    "PSF-CHI2": _e(None, "min_max", [(0, 3.0), (0, 10.0), (0, 100.0)],
                   "full", "PSF fit median chi2", pos=True),
    "PSF-SEE": _skip("full", "[arcsec] PSF-model seeing"),
    "PSF-FWHM": _skip("full", "[arcsec] PSF-model FWHM"),
    "PSF-SIZE": _skip("full", "[pix] PSF stamp size"),
    "PSF-CFGS": _skip("full", "[pix] PSF config sampling"),

    # ---- bookkeeping ('full') ----
    "QC-FLAG": _skip("full", "QC flag colour"),
    "DUMCAT": _e(False, "bool", [False], "full",
                 "dummy catalog without sources?"),
    "REDFILE": _skip("full", "reduced image filename"),
    "MASKFILE": _skip("full", "mask image filename"),

    # ---- master bias ('mbias') ----
    "NBIAS": _e(None, "min_max", [(10, 50), (7, 50), (3, 50)], "mbias",
                "number of bias frames combined", pos=True),
    "MBMEAN": _e(None, "min_max", [(-2, 2), (-5, 5), (-20, 20)], "mbias",
                 "[e-] mean master bias"),
    "MBRDN": _e(None, "min_max", [(0, 10), (0, 20), (0, 50)], "mbias",
                "[e-] sigma (STD) master bias", pos=True),

    # ---- individual flats ('flat') ----
    "MEDSEC": _e(None, "min_max", [(15000, 80000), (10000, 100000),
                                   (2000, 200000)], "flat",
                 "[e-] median flat level in STATSEC", pos=True),
    "RSTDSEC": _e(None, "min_max", [(0, 0.03), (0, 0.08), (0, 0.5)],
                  "flat", "relative STD of flat in STATSEC", pos=True),
    "FLATRSTD": _e(None, "min_max", [(0, 0.08), (0, 0.15), (0, 0.5)],
                   "flat", "relative STD of flat", pos=True),
    "RDIF-MAX": _e(None, "min_max", [(0, 0.06), (0, 0.12), (0, 0.5)],
                   "flat", "max relative difference between subimages",
                   pos=True),
    "RSTD-MAX": _e(None, "min_max", [(0, 0.06), (0, 0.12), (0, 0.5)],
                   "flat", "max relative STD of subimages", pos=True),

    # ---- master flat ('mflat') ----
    "NFLAT": _e(None, "min_max", [(6, 50), (4, 50), (3, 50)], "mflat",
                "number of flat frames combined", pos=True),
    "MFMEDSEC": _e(None, "sigma", [(1.0, 0.001)], "mflat",
                   "median master flat over STATSEC"),
    "MFSTDSEC": _e(None, "min_max", [(0, 0.05), (0, 0.1), (0, 1.0)],
                   "mflat", "STD master flat over STATSEC", pos=True),
    "FLATDITH": _e(None, "bool", [True], "mflat",
                   "majority of flats were dithered"),

    # ---- transient catalog ('trans') ----
    "SWARP-P": _e(False, "bool", [True], "trans",
                  "reference image successfully remapped?"),
    "Z-P": _e(False, "bool", [True], "trans",
              "ZOGY subtraction succeeded?"),
    "MC-P": _e(False, "bool", [True, False], "trans",
               "transients ML-classified?"),
    "T-NTRANS": _e(0, "min_max", [(0, 300), (0, 1500), (0, 10**6)],
                   "trans", "number of transient candidates", pos=True),
    "T-FTRANS": _e(None, "min_max", [(0, 0.02), (0, 0.1), (0, 1.0)],
                   "trans", "transient fraction of sources", pos=True),
    "T-NSIGMA": _skip("trans", "[sigma] transient detection threshold"),
    "T-LMAG": _e(None, "min_max", _per_filter(
        {f: [(17.0, 24.0), (15.0, 25.0), (0, 30)] for f in FILTERS}),
        "trans", "[mag] transient limiting magnitude", pos=True),
    "T-LFNU": _skip("trans", "[uJy] transient limiting flux"),
    "T-FRATIO": _e(None, "min_max", [(0.2, 5.0), (0.05, 20.0),
                                     (0.001, 1000.0)], "trans",
                   "new/ref flux ratio", pos=True),
    "Z-FNR": _e(None, "min_max", [(0.7, 1.3), (0.4, 2.5), (0.06, 15.0)],
                "trans", "median flux ratio Fnew/Fref", pos=True),
    "Z-FNRSTD": _e(None, "min_max", [(0, 0.2), (0, 0.5), (0, 10.0)],
                   "trans", "STD of flux ratio", pos=True),
    "Z-FNRERR": _skip("trans", "error on the flux ratio"),
    "Z-FRATIO": _e(None, "min_max", [(0.2, 5.0), (0.05, 20.0),
                                     (0.001, 1000.0)], "trans",
                   "PSF-star flux ratio new/ref", pos=True),
    "Z-FRSTD": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10.0)],
                  "trans", "STD of PSF-star flux ratio", pos=True),
    "Z-DX": _e(None, "min_max", [(-0.3, 0.3), (-1, 1), (-10, 10)],
               "trans", "[pix] x shift new vs ref"),
    "Z-DY": _e(None, "min_max", [(-0.3, 0.3), (-1, 1), (-10, 10)],
               "trans", "[pix] y shift new vs ref"),
    "Z-DXSTD": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10)],
                  "trans", "[pix] x shift STD", pos=True),
    "Z-DYSTD": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10)],
                  "trans", "[pix] y shift STD", pos=True),
    "Z-DXRMS": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10)],
                  "trans", "[pix] x shift rms", pos=True),
    "Z-DYRMS": _e(None, "min_max", [(0, 0.3), (0, 1.0), (0, 10)],
                  "trans", "[pix] y shift rms", pos=True),
    "Z-SCMED": _e(None, "min_max", [(-0.3, 0.3), (-1, 1), (-10, 10)],
                  "trans", "median Scorr"),
    "Z-SCSTD": _e(None, "min_max", [(0.7, 1.5), (0.4, 2.5), (0.1, 10)],
                  "trans", "STD of Scorr", pos=True),
    "T-NPOS": _skip("trans", "positive transient candidates"),
    "T-NNEG": _skip("trans", "negative transient candidates"),
    "T-NVET": _skip("trans", "candidates vetted out"),
    "TQC-FLAG": _skip("trans", "transient QC flag colour"),
    "TDUMCAT": _e(False, "bool", [False], "trans",
                  "dummy transient catalog without sources?"),
}


def _per_channel(fmt: str, entry: dict, nchan: int = 16) -> dict:
    """Expand one range entry to per-channel keywords (the reference's
    set_qc.py carries 16 literal entries per quantity — here generated)."""
    out = {}
    for c in range(1, nchan + 1):
        e = dict(entry)
        e["comment"] = f"channel {c} " + e.get("comment", "")
        out[fmt.format(c)] = e
    return out


_BASE.update(_per_channel(
    "BIASM{}", _e(None, "min_max", [(3000, 25000), (1000, 35000),
                                    (0, 60000)], "full",
                  "[e-] mean vertical overscan", pos=True)))
_BASE.update(_per_channel(
    "RDN{}", _e(None, "min_max", [(5, 15), (3, 20), (2, 30)], "full",
                "[e-] read noise (sigma vertical overscan)", pos=True)))
_BASE.update(_per_channel(
    "SATLEV{}", _e(None, "min_max", [(30000, 200000)], "full",
                   "[e-] saturation threshold", pos=True)))
_BASE.update(_per_channel(
    "GAIN{}", _skip("full", "[e-/ADU] gain")))
_BASE.update(_per_channel(
    "FLATRS{}", _e(None, "min_max", [(0, 0.05), (0, 0.1), (0, 0.5)],
                   "flat", "relative sigma (STD) flat", pos=True)))
_BASE.update(_per_channel(
    "FLATM{}", _skip("flat", "[e-] median flat level")))
_BASE.update(_per_channel(
    "MBIASM{}", _e(None, "min_max", [(-2, 2), (-5, 5), (-20, 20)],
                   "mbias", "[e-] mean master bias")))
_BASE.update(_per_channel(
    "MBRDN{}", _e(None, "min_max", [(0, 10), (0, 20), (0, 50)],
                  "mbias", "[e-] sigma (STD) master bias", pos=True)))
_BASE.update(_per_channel(
    "GAINCF{}", _e(None, "exp_abs", [(1.0, 0.1), (1.0, 0.25), (1.0, 0.6)],
                   "mflat", "gain correction factor", pos=True)))


def _ref_section() -> dict:
    """Per-filter co-add grading (shape of the reference's 'BG' ref
    block, set_qc.py:63-91: per-filter seeing caps and sigma windows)."""
    return {
        "R-NUSED": _e(None, "min_max", [(3, 40), (2, 60), (1, 100)],
                      "ref", "images used in co-add", pos=True),
        "S-SEEING": _e(None, "min_max", _per_filter(
            {"u": [(0.1, 2.6)], "g": [(0.1, 2.5)], "q": [(0.1, 2.4)],
             "r": [(0.1, 2.0)], "i": [(0.1, 2.1)], "z": [(0.1, 2.5)]}),
            "ref", "[arcsec] co-add seeing", pos=True),
        "S-ELONG": _e(None, "sigma", [(1.1, 0.2)], "ref",
                      "co-add median elongation", pos=True),
        "S-BKG": _e(None, "min_max", [(0, 5e2)], "ref",
                    "[e-] co-add median background"),
        "PSF-CHI2": _e(None, "sigma", [(1.1, 0.2)], "ref",
                       "co-add PSF fit reduced chi2", pos=True),
        "PC-ZPSTD": _e(None, "sigma", _per_filter(
            {"u": [(0.07, 0.03)], "g": [(0.03, 0.03)],
             "q": [(0.02, 0.03)], "r": [(0.02, 0.03)],
             "i": [(0.02, 0.03)], "z": [(0.03, 0.03)]}),
            "ref", "[mag] co-add zeropoint STD", pos=True),
    }


# ref grading uses dedicated entries where names collide with 'full'
QC_RANGES_REF = {"ML1": _ref_section(), "BG": _ref_section()}

QC_RANGES = {
    "ML1": _BASE,
    # BlackGEM telescopes share the base with small deviations
    "BG": {**_BASE,
           "RDNOISE": _e(None, "min_max", [(5, 13), (3, 18), (2, 30)],
                         "full", "[e-] average channel read noise",
                         pos=True)},
}
