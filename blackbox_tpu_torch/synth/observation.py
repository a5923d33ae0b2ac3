"""Synthetic observations as raw FITS files with survey-style headers.

Gives the host driver and the night scheduler a true file-level fixture:
raw frames written the way the telescope control system delivers them
(unsigned 16-bit mosaics, GPS shutter times, JNOW pointing strings,
IMAGETYP/OBJECT/FILTER keywords — the keyword population handled by the
reference's set_header/check_header layer, reference blackbox.py:
5445-6291).
"""

from __future__ import annotations

import os

import numpy as np

from blackbox_tpu_torch.astro.time import mjd2iso
from blackbox_tpu_torch.core.geometry import CCDGeometry
from blackbox_tpu_torch.io.fits import Header, write_image
from blackbox_tpu_torch.synth.generator import (
    make_raw_bias, make_raw_flat, make_raw_science)


def raw_header(telescope: str, imgtype: str, mjd_start: float,
               exptime: float, filt: str = "q", field_id: int = 42,
               ra_deg: float = 150.0, dec_deg: float = -30.0) -> Header:
    h = Header()
    h["IMAGETYP"] = (imgtype, "image type")
    h["DATE-OBS"] = (mjd2iso(mjd_start), "UTC start of exposure")
    h["EXPTIME"] = (exptime, "[s] exposure time")
    h["FILTER"] = (filt, "filter")
    h["TELESCOP"] = (telescope, "telescope")
    if imgtype == "flat":
        # twilight flats carry (dithered) pointings — the master-flat
        # dither check reads them (reference blackbox.py:5027-5055)
        h["RA"] = (round(ra_deg, 6), "[deg] telescope RA")
        h["DEC"] = (round(dec_deg, 6), "[deg] telescope DEC")
    if imgtype == "object":
        h["OBJECT"] = (str(field_id), "field ID")
        # mount pointing as sexagesimal strings (JNOW, like the TCS):
        # the commanded ICRS field centre precessed to the epoch
        from blackbox_tpu_torch.astro.time import icrs2jnow
        ra_deg, dec_deg = icrs2jnow(ra_deg, dec_deg,
                                    mjd_start + exptime / 172800.0)
        rah = ra_deg / 15.0
        h["RA"] = (f"{int(rah):02d}:{int(rah % 1 * 60):02d}:"
                   f"{rah % 1 * 60 % 1 * 60:06.3f}", "telescope RA (hms)")
        sgn = "-" if dec_deg < 0 else "+"
        ad = abs(dec_deg)
        h["DEC"] = (f"{sgn}{int(ad):02d}:{int(ad % 1 * 60):02d}:"
                    f"{ad % 1 * 60 % 1 * 60:05.2f}", "telescope DEC (dms)")
        h["GPSSTART"] = (mjd2iso(mjd_start), "GPS shutter open")
        h["GPSEND"] = (mjd2iso(mjd_start + (exptime + 0.05) / 86400.0),
                       "GPS shutter close")
        # the TCS writes tracking state as a STRING (reference
        # blackbox.py:1092, 5745-5750 str2bool-normalises it)
        h["ISTRACKI"] = ("True", "Telescope is tracking")
    else:
        h["OBJECT"] = (imgtype, "")
    return h


def write_observation(path: str, geom: CCDGeometry, rng, imgtype: str,
                      telescope: str = "ML1", mjd_start: float = 60000.0,
                      exptime: float = 60.0, filt: str = "q",
                      field_id: int = 42, ra_deg: float = 150.0,
                      dec_deg: float = -30.0, **synth_kw):
    """Generate + write one raw frame; returns (truth, header)."""
    if imgtype == "bias":
        raw, truth = make_raw_bias(geom, rng, telescope=telescope)
        exptime = 0.0
    elif imgtype == "dark":
        from blackbox_tpu_torch.synth.generator import make_raw_dark
        raw, truth = make_raw_dark(geom, rng, telescope=telescope,
                                   exptime=exptime, **synth_kw)
    elif imgtype == "flat":
        raw, truth = make_raw_flat(geom, rng, telescope=telescope,
                                   **synth_kw)
        exptime = 3.0
    elif imgtype == "object":
        raw, truth = make_raw_science(geom, rng, telescope=telescope,
                                      **synth_kw)
    else:
        raise ValueError(imgtype)
    h = raw_header(telescope, imgtype, mjd_start, exptime, filt,
                   field_id, ra_deg, dec_deg)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_image(path, np.round(np.clip(raw, 0, 65535)).astype(np.uint16), h)
    return truth, h


def night_of_observations(root: str, geom: CCDGeometry, rng,
                          telescope: str = "ML1", date: str = "20260301",
                          nbias: int = 3, nflat: int = 3, nsci: int = 2,
                          filt: str = "q", **synth_kw):
    """A miniature observing night in the raw tree; returns file list."""
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.synth.generator import _vignette_flat
    tree = DataTree(root, telescope)
    d = tree.raw_dir(date)
    os.makedirs(d, exist_ok=True)
    iso = f"{date[:4]}-{date[4:6]}-{date[6:8]}T23:00:00.000"
    mjd0 = iso2mjd(iso)
    # ONE instrument response shared by every frame of the night — the
    # master flat must describe the science frames' vignetting
    flat = _vignette_flat(geom, rng)
    # repeated visits of the same field share their star field
    if nsci > 1 and "stars" not in synth_kw:
        H, W = geom.red_shape
        ns = synth_kw.get("nstars", 200)
        fw = synth_kw.get("fwhm", 3.0)
        fr = synth_kw.get("flux_range", (2e3, 2e5))
        xs = rng.uniform(8, W - 8, ns)
        ys = rng.uniform(8, H - 8, ns)
        fl = np.exp(rng.uniform(np.log(fr[0]), np.log(fr[1]), ns))
        synth_kw = dict(synth_kw,
                        stars=np.stack([xs, ys, fl,
                                        np.full(ns, fw)], 1))
    files, truths = [], []
    seq = [("bias", i) for i in range(nbias)] \
        + [("flat", i) for i in range(nflat)] \
        + [("object", i) for i in range(nsci)]
    for k, (imgtype, i) in enumerate(seq):
        mjd = mjd0 + k * 120.0 / 86400.0
        ts = mjd2iso(mjd).replace("-", "").replace(":", "")
        name = f"{telescope}_{ts[:8]}_{ts[9:15]}.fits"
        path = os.path.join(d, name)
        if imgtype == "object":
            kw = dict(synth_kw, flat=flat)
        elif imgtype == "flat":
            # dither twilight flats by ~15" so FLATDITH passes
            kw = {"flat": flat,
                  "ra_deg": synth_kw.get("ra_deg", 150.0)
                  + i * 15.0 / 3600.0,
                  "dec_deg": synth_kw.get("dec_deg", -30.0)}
        else:
            kw = {}
        truth, h = write_observation(
            path, geom, rng, imgtype, telescope, mjd, filt=filt, **kw)
        files.append(path)
        truths.append(truth)
    return files, truths, tree
