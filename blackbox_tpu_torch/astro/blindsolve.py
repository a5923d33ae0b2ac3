"""Blind astrometric solve (Astrometry.net equivalent).

The reference pipeline's WCS comes from Astrometry.net's solve-field,
invoked through zogy against pre-built index files (SURVEY.md §2.4 row
"Astrometry.net"; A-* QC keys set_qc.py:271-292).  The production path
here is the *seeded* solve in :mod:`blackbox_tpu_torch.astro.astrometry`
(pointing always known to ~10 arcmin), and this module is the
lost-pointing fallback: a native C++ geometric quad-hash matcher
(``csrc/quadmatch.cpp``, Lang et al. 2010) driven via ctypes.  Port of
:mod:`blackbox_tpu.astro.blindsolve`: the matcher builds into the
port's ``_build/``.

Usage::

    index = QuadIndex.build(ra, dec, mag, scale_min_deg, scale_max_deg)
    index.save("ML1_gaia_index.npz")          # once, offline
    ...
    sol = blind_solve(x, y, flux, index, image_shape, pixscale_hint)

The index is built from the same reference catalog (Gaia subset) that
seeds photometric calibration, so no extra data products are needed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import numpy as np

from blackbox_tpu_torch.astro.astrometry import SolveResult, solve_tan
from blackbox_tpu_torch.astro.wcs import TanWCS

_LIB = None
_LIB_TRIED = False


def _build_lib():
    """Compile csrc/quadmatch.cpp into the package's ``_build/``
    directory (listed in ``.gitignore``; never into the source tree),
    cached until the source changes.  The library is written under a
    private name and renamed into place, so processes building at once
    never load a half-written file."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "csrc", "quadmatch.cpp")
    build = os.path.join(os.path.dirname(here), "_build")
    out = os.path.join(build, "quadmatch.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(build, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o",
               tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _get_lib():
    global _LIB, _LIB_TRIED
    if _LIB is None and not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(_build_lib())
            dptr = ctypes.POINTER(ctypes.c_double)
            iptr = ctypes.POINTER(ctypes.c_int32)
            lib.quad_index_build.restype = ctypes.c_long
            lib.quad_index_build.argtypes = [
                dptr, dptr, ctypes.c_long, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, iptr, dptr, ctypes.c_long]
            lib.quad_solve.restype = ctypes.c_long
            lib.quad_solve.argtypes = [
                dptr, dptr, ctypes.c_long, ctypes.c_long,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, dptr, dptr, ctypes.c_long,
                iptr, dptr, ctypes.c_long, ctypes.c_double,
                ctypes.c_double, ctypes.c_long, dptr]
            _LIB = lib
        except Exception:
            _LIB = None
    return _LIB


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


@dataclasses.dataclass
class QuadIndex:
    """Quad-hash index over a reference star catalog."""

    ra: np.ndarray          # [deg] star positions, brightest first
    dec: np.ndarray
    mag: np.ndarray
    quads: np.ndarray       # (N, 4) int32 star indices (canonical order)
    codes: np.ndarray       # (N, 4) float64, sorted by codes[:, 0]
    scale_min: float        # [deg] quad diameter range the index covers
    scale_max: float

    @classmethod
    def build(cls, ra, dec, mag, scale_min_deg: float,
              scale_max_deg: float, nmax_stars: int = 4000,
              quads_per_star: int = 12,
              max_quads: int = 200_000) -> "QuadIndex":
        """Build the index from a catalog (any order; sorted by mag)."""
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("quadmatch C++ library failed to build")
        ra = np.ascontiguousarray(ra, np.float64)
        dec = np.ascontiguousarray(dec, np.float64)
        mag = np.ascontiguousarray(mag, np.float64)
        order = np.argsort(mag)[:nmax_stars]
        ra, dec, mag = ra[order], dec[order], mag[order]
        n = len(ra)
        quads = np.empty((max_quads, 4), np.int32)
        codes = np.empty((max_quads, 4), np.float64)
        nq = lib.quad_index_build(
            _dp(ra), _dp(dec), n, float(scale_min_deg),
            float(scale_max_deg), int(quads_per_star), _ip(quads),
            _dp(codes), max_quads)
        return cls(ra, dec, mag, np.ascontiguousarray(quads[:nq]),
                   np.ascontiguousarray(codes[:nq]),
                   float(scale_min_deg), float(scale_max_deg))

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, ra=self.ra, dec=self.dec, mag=self.mag,
            quads=self.quads, codes=self.codes,
            scale=np.array([self.scale_min, self.scale_max]))

    @classmethod
    def load(cls, path: str) -> "QuadIndex":
        z = np.load(path)
        return cls(z["ra"], z["dec"], z["mag"], z["quads"], z["codes"],
                   float(z["scale"][0]), float(z["scale"][1]))


def blind_solve(x, y, flux, index: QuadIndex, image_shape,
                pixscale_hint: float | None = None,
                nuse: int = 40, code_tol: float = 0.01,
                pix_tol: float = 3.0, min_match: int = 12,
                refine: bool = True) -> SolveResult:
    """Solve the WCS of a detection list with no pointing information.

    x, y, flux     : detections (0-based pixel coords)
    index          : a :class:`QuadIndex` over the reference catalog
    image_shape    : (ny, nx) of the image
    pixscale_hint  : approximate pixel scale [arcsec/pix]; bounds the
                     detection-quad sizes so they fall inside the
                     index's angular scale range.  None => derive the
                     bounds from the image diagonal alone.
    """
    lib = _get_lib()
    ny, nx = image_shape
    if lib is None:
        # no compiler / library on this host: degrade to a failed solve
        # so the driver's lost-pointing fallback red-flags the frame
        # instead of crashing the whole reduction
        import logging
        logging.getLogger("blackbox_tpu").error(
            "quadmatch C++ library unavailable; blind solve disabled")
        wcs = TanWCS.simple(0.0, 0.0, pixscale_hint or 1.0, image_shape)
        return SolveResult(wcs, 0, float("inf"), False)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    order = np.argsort(-np.asarray(flux))
    xs = np.ascontiguousarray(x[order])
    ys = np.ascontiguousarray(y[order])

    if pixscale_hint:
        qpix_min = index.scale_min * 3600.0 / pixscale_hint
        qpix_max = index.scale_max * 3600.0 / pixscale_hint
    else:
        diag = float(np.hypot(nx, ny))
        qpix_min, qpix_max = 0.05 * diag, 0.6 * diag

    out = np.zeros(10, np.float64)
    nmatch = lib.quad_solve(
        _dp(xs), _dp(ys), len(xs), int(nuse),
        float(qpix_min), float(qpix_max), float(nx), float(ny),
        _dp(index.ra), _dp(index.dec), len(index.ra),
        _ip(index.quads), _dp(index.codes), len(index.quads),
        float(code_tol), float(pix_tol), int(min_match), _dp(out))
    if nmatch < min_match:
        wcs = TanWCS.simple(0.0, 0.0, pixscale_hint or 1.0, image_shape)
        return SolveResult(wcs, int(nmatch), float("inf"), False)

    cd = np.array([[out[6], out[7]], [out[8], out[9]]], np.float64)
    wcs = TanWCS(out[2], out[3], out[4], out[5], cd)
    if not refine:
        return SolveResult(wcs, int(nmatch), float(out[1]), True)
    # polish with the seeded solver — restricted to index stars that
    # actually fall on the image, else its brightest-N reference cut
    # starves the fit (the index can cover a much larger sky area)
    rx, ry = wcs.sky2pix(index.ra, index.dec)
    margin = 50.0
    infield = ((rx > -margin) & (rx < nx + margin)
               & (ry > -margin) & (ry < ny + margin))
    sol = solve_tan(x, y, flux, index.ra[infield], index.dec[infield],
                    index.mag[infield], wcs)
    if not sol.ok:      # keep the verified quad solution regardless
        return SolveResult(wcs, int(nmatch), float(out[1]), True)
    return sol
