"""TAN (gnomonic) world coordinate system.

Replaces the reference's dependence on astropy.wcs + Astrometry.net output
headers (A-* keywords, SURVEY.md §2.4): a CD-matrix TAN projection with
pix<->sky transforms in numpy (host, float64), plus FITS header
(de)serialisation of the standard CRVAL/CRPIX/CD cards.  A copy of
:mod:`blackbox_tpu.astro.wcs` (``tests/test_torch_import.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

D2R = np.pi / 180.0


@dataclasses.dataclass
class TanWCS:
    crval1: float           # RA at reference point [deg]
    crval2: float           # DEC at reference point [deg]
    crpix1: float           # reference pixel x (1-based, FITS)
    crpix2: float
    cd: np.ndarray          # 2x2 CD matrix [deg/pix]

    # ---- projections ----
    def sky2tan(self, ra, dec):
        """RA/DEC [deg] -> tangent-plane xi/eta [deg]."""
        ra = np.asarray(ra, np.float64) * D2R
        dec = np.asarray(dec, np.float64) * D2R
        ra0 = self.crval1 * D2R
        dec0 = self.crval2 * D2R
        cosc = (np.sin(dec0) * np.sin(dec)
                + np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0))
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc
        eta = (np.cos(dec0) * np.sin(dec)
               - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc
        return xi / D2R, eta / D2R

    def tan2sky(self, xi, eta):
        xi = np.asarray(xi, np.float64) * D2R
        eta = np.asarray(eta, np.float64) * D2R
        ra0 = self.crval1 * D2R
        dec0 = self.crval2 * D2R
        den = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, den)
        dec = np.arctan((np.sin(dec0) + eta * np.cos(dec0))
                        / np.sqrt(xi ** 2 + den ** 2))
        return (np.mod(ra / D2R, 360.0), dec / D2R)

    def pix2sky(self, x, y):
        """0-based pixel coords -> RA/DEC [deg]."""
        dx = np.asarray(x, np.float64) + 1.0 - self.crpix1
        dy = np.asarray(y, np.float64) + 1.0 - self.crpix2
        xi = self.cd[0, 0] * dx + self.cd[0, 1] * dy
        eta = self.cd[1, 0] * dx + self.cd[1, 1] * dy
        return self.tan2sky(xi, eta)

    def sky2pix(self, ra, dec):
        xi, eta = self.sky2tan(ra, dec)
        inv = np.linalg.inv(self.cd)
        dx = inv[0, 0] * xi + inv[0, 1] * eta
        dy = inv[1, 0] * xi + inv[1, 1] * eta
        return dx + self.crpix1 - 1.0, dy + self.crpix2 - 1.0

    # ---- properties ----
    @property
    def pixscale(self) -> float:
        """[arcsec/pix] geometric mean scale."""
        return float(np.sqrt(abs(np.linalg.det(self.cd))) * 3600.0)

    @property
    def rotation(self) -> float:
        """[deg] rotation of +y axis from North (E-of-N)."""
        return float(np.degrees(np.arctan2(self.cd[0, 1], self.cd[1, 1])))

    # ---- FITS cards ----
    def to_header(self, h):
        h["CTYPE1"] = ("RA---TAN", "WCS projection")
        h["CTYPE2"] = ("DEC--TAN", "WCS projection")
        h["CRVAL1"] = (self.crval1, "[deg] RA at reference point")
        h["CRVAL2"] = (self.crval2, "[deg] DEC at reference point")
        h["CRPIX1"] = (self.crpix1, "[pix] reference pixel x")
        h["CRPIX2"] = (self.crpix2, "[pix] reference pixel y")
        h["CD1_1"] = (self.cd[0, 0], "[deg/pix] CD matrix")
        h["CD1_2"] = (self.cd[0, 1], "[deg/pix] CD matrix")
        h["CD2_1"] = (self.cd[1, 0], "[deg/pix] CD matrix")
        h["CD2_2"] = (self.cd[1, 1], "[deg/pix] CD matrix")
        h["A-PSCALE"] = (self.pixscale, "[arcsec/pix] pixel scale")
        h["A-ROT"] = (self.rotation, "[deg] rotation from N-up")
        return h

    @classmethod
    def from_header(cls, h):
        cd = np.array([[h["CD1_1"], h["CD1_2"]],
                       [h["CD2_1"], h["CD2_2"]]], np.float64)
        return cls(float(h["CRVAL1"]), float(h["CRVAL2"]),
                   float(h["CRPIX1"]), float(h["CRPIX2"]), cd)

    @classmethod
    def simple(cls, ra0, dec0, pixscale_arcsec, shape, rot_deg=0.0,
               flip_x=True):
        """N-up/E-left WCS centred on (ra0, dec0)."""
        s = pixscale_arcsec / 3600.0
        c, sn = np.cos(rot_deg * D2R), np.sin(rot_deg * D2R)
        sx = -s if flip_x else s
        cd = np.array([[sx * c, s * sn], [-sx * sn, s * c]], np.float64)
        return cls(float(ra0), float(dec0), shape[1] / 2.0 + 0.5,
                   shape[0] / 2.0 + 0.5, cd)


def haversine(ra1, dec1, ra2, dec2):
    """Great-circle separation [deg] (reference uses the same formula for
    dither checks, blackbox.py:5027-5055)."""
    ra1, dec1, ra2, dec2 = [np.asarray(a, np.float64) * D2R
                            for a in (ra1, dec1, ra2, dec2)]
    d = 2 * np.arcsin(np.sqrt(
        np.sin((dec2 - dec1) / 2) ** 2
        + np.cos(dec1) * np.cos(dec2) * np.sin((ra2 - ra1) / 2) ** 2))
    return d / D2R
