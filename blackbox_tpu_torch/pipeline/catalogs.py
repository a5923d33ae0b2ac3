"""Catalog schemas, FITS packaging, and dummy-catalog emission.

The reference delegates catalog formatting to zogy's ``format_cat`` and
emits zero-row dummy catalogs whenever QC red-flags a product so the
downstream schema never breaks (reference qc.py:451-504,
blackbox.py:2018-2048).  The same contract lives here: fixed column
schemas per catalog type, device catalog -> numpy columns conversion with
the validity mask applied, and dummy writers filling header defaults from
the QC table.
"""

from __future__ import annotations

import numpy as np

from blackbox_tpu_torch.io.fits import Header, write_image

# column name, dtype, per-aperture? (expanded with the radii count)
SCHEMAS = {
    "new": [
        ("NUMBER", np.int32, False),
        ("X_POS", np.float32, False),
        ("Y_POS", np.float32, False),
        ("XVAR_POS", np.float32, False),
        ("YVAR_POS", np.float32, False),
        ("RA", np.float64, False),
        ("DEC", np.float64, False),
        ("ELONGATION", np.float32, False),
        ("FWHM", np.float32, False),
        ("CLASS_STAR", np.float32, False),
        ("FLAGS", np.int16, False),
        ("FLAGS_MASK", np.int16, False),
        ("BACKGROUND", np.float32, False),
        ("E_FLUX_APER", np.float32, "aper"),
        ("E_FLUXERR_APER", np.float32, "aper"),
        ("MAG_APER", np.float32, "aper"),
        ("MAGERR_APER", np.float32, "aper"),
        ("E_FLUX_AUTO", np.float32, False),
        ("E_FLUXERR_AUTO", np.float32, False),
        ("MAG_AUTO", np.float32, False),
        ("MAGERR_AUTO", np.float32, False),
        ("E_FLUX_OPT", np.float32, False),
        ("E_FLUXERR_OPT", np.float32, False),
        ("MAG_OPT", np.float32, False),
        ("MAGERR_OPT", np.float32, False),
        ("SNR_OPT", np.float32, False),
    ],
    "trans": [
        ("NUMBER", np.int32, False),
        ("X_PEAK", np.float32, False),
        ("Y_PEAK", np.float32, False),
        ("RA_PEAK", np.float64, False),
        ("DEC_PEAK", np.float64, False),
        ("SNR_ZOGY", np.float32, False),
        ("E_FLUX_ZOGY", np.float32, False),
        ("E_FLUXERR_ZOGY", np.float32, False),
        ("MAG_ZOGY", np.float32, False),
        ("MAGERR_ZOGY", np.float32, False),
        ("X_POS_SCORR", np.float32, False),
        ("Y_POS_SCORR", np.float32, False),
        ("ELONG_GAUSS", np.float32, False),
        ("FWHM_GAUSS", np.float32, False),
        ("CHI2_GAUSS", np.float32, False),
        ("CLASS_REAL", np.float32, False),
    ],
}
SCHEMAS["ref"] = SCHEMAS["new"]


def schema_columns(cat_type: str, n_aper: int):
    cols = []
    for name, dt, aper in SCHEMAS[cat_type]:
        cols.append((name, dt, n_aper if aper == "aper" else None))
    return cols


def empty_catalog(cat_type: str, n_aper: int = 3):
    out = {}
    for name, dt, width in schema_columns(cat_type, n_aper):
        shape = (0, width) if width else (0,)
        out[name] = np.zeros(shape, dt)
    return out


def device_cat_to_columns(cat: dict, zeropoint: float | None,
                          airmass: float = 1.0, ext_coeff: float = 0.0,
                          wcs=None, n_aper: int = 3, exptime: float = 1.0):
    """Convert the device catalog (tensors, on any device) to schema'd
    numpy columns."""
    cat = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
           for k, v in cat.items()}
    valid = np.asarray(cat["valid"])
    sel = np.flatnonzero(valid)
    n = sel.size
    x = np.asarray(cat["x"])[sel]
    y = np.asarray(cat["y"])[sel]
    flux_ap = np.asarray(cat["flux_ap"])[sel]
    fluxerr_ap = np.asarray(cat["fluxerr_ap"])[sel]

    def mags(flux, err):
        with np.errstate(divide="ignore", invalid="ignore"):
            zp = zeropoint if zeropoint is not None else 0.0
            # zeropoint convention: mag = zp − 2.5·log10(flux/exptime)
            # − k·airmass (zogy apply_zp contract)
            mag = zp - 2.5 * np.log10(np.maximum(flux, 1e-30)
                                      / max(exptime, 1e-9)) \
                - ext_coeff * airmass
            magerr = 1.0857 * err / np.maximum(flux, 1e-30)
        bad = flux <= 0
        mag[bad] = 99.0
        magerr[bad] = 99.0
        return mag.astype(np.float32), magerr.astype(np.float32)

    # optimal flux = PSF matched-filter flux when the PSF stage ran
    # (zogy E_FLUX_OPT contract); largest aperture otherwise
    if "flux_psf" in cat:
        flux_opt = np.asarray(cat["flux_psf"])[sel]
        fluxerr_opt = np.asarray(cat["fluxerr_psf"])[sel]
    else:
        flux_opt = flux_ap[:, -1]
        fluxerr_opt = fluxerr_ap[:, -1]
    mag_ap, magerr_ap = mags(flux_ap, fluxerr_ap)
    mag_opt, magerr_opt = mags(flux_opt, fluxerr_opt)

    if wcs is not None:
        ra, dec = wcs.pix2sky(x, y)
    else:
        ra = np.zeros(n, np.float64)
        dec = np.zeros(n, np.float64)

    cols = {
        "NUMBER": np.arange(1, n + 1, dtype=np.int32),
        "X_POS": (x + 1).astype(np.float32),      # FITS 1-based
        "Y_POS": (y + 1).astype(np.float32),
        "XVAR_POS": np.asarray(cat["x2"])[sel].astype(np.float32),
        "YVAR_POS": np.asarray(cat["y2"])[sel].astype(np.float32),
        "RA": ra, "DEC": dec,
        "ELONGATION": np.asarray(cat["elong"])[sel].astype(np.float32),
        "FWHM": np.asarray(cat["fwhm"])[sel].astype(np.float32),
        "CLASS_STAR": np.ones(n, np.float32),
        "FLAGS": np.zeros(n, np.int16),
        "FLAGS_MASK": np.zeros(n, np.int16),
        "BACKGROUND": np.zeros(n, np.float32),
        "E_FLUX_APER": flux_ap.astype(np.float32),
        "E_FLUXERR_APER": fluxerr_ap.astype(np.float32),
        "MAG_APER": mag_ap, "MAGERR_APER": magerr_ap,
        "E_FLUX_AUTO": np.asarray(cat["flux_iso"])[sel].astype(np.float32),
        "E_FLUXERR_AUTO": fluxerr_opt.astype(np.float32),
        "MAG_AUTO": mags(np.asarray(cat["flux_iso"])[sel],
                         fluxerr_opt)[0],
        "MAGERR_AUTO": magerr_opt,
        "E_FLUX_OPT": flux_opt.astype(np.float32),
        "E_FLUXERR_OPT": fluxerr_opt.astype(np.float32),
        "MAG_OPT": mag_opt, "MAGERR_OPT": magerr_opt,
        "SNR_OPT": np.asarray(cat["snr"])[sel].astype(np.float32),
    }
    return cols


def write_catalog(path: str, columns: dict, header: Header,
                  cat_type: str = "new"):
    header = header.copy()
    nrows = len(next(iter(columns.values()))) if columns else 0
    header["NAXIS2-C"] = (nrows, "number of catalog rows")
    header["CATTYPE"] = (cat_type, "catalog type")
    write_image(path, None, Header(), extensions=[("table", columns,
                                                   header)])


def write_dummy_catalog(path: str, header: Header, cat_type: str,
                        telescope: str = "ML1", n_aper: int = 3):
    """Zero-row catalog with QC defaults filled in (reference qc.py:451-504).

    Header keywords that the QC table knows about but the header lacks are
    filled with their declared defaults so the schema contract holds.
    """
    from blackbox_tpu_torch.qc.ranges import QC_RANGES
    from blackbox_tpu_torch.config.base import get_par
    table = get_par(QC_RANGES, telescope)
    h = header.copy()
    for key, entry in table.items():
        if key not in h and entry.get("default") is not None:
            h[key] = (entry["default"], entry.get("comment", "QC default"))
    h["DUMCAT"] = (True, "dummy (zero-row) catalog?")
    write_catalog(path, empty_catalog(cat_type, n_aper), h, cat_type)
