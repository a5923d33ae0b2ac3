"""Time scales: ISO <-> MJD, sidereal time.

The reference uses astropy.time for DATE-OBS handling, LST and MJD-OBS
(reference blackbox.py:5772-5814); this module provides the same
conversions from first principles (UTC treated as UT1; the <1 s difference
is irrelevant at the survey's astrometric tolerance).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

MJD0 = 2400000.5


def iso2mjd(iso: str) -> float:
    """'YYYY-MM-DDTHH:MM:SS.sss' -> MJD (UTC)."""
    s = iso.strip().replace(" ", "T")
    if "." in s:
        main, frac = s.split(".")
        dt = _dt.datetime.strptime(main, "%Y-%m-%dT%H:%M:%S")
        dt = dt.replace(microsecond=int(float("0." + frac) * 1e6))
    else:
        dt = _dt.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S")
    return datetime2mjd(dt)


def datetime2mjd(dt: _dt.datetime) -> float:
    epoch = _dt.datetime(1858, 11, 17)
    delta = dt - epoch
    return delta.days + delta.seconds / 86400.0 + delta.microseconds / 86.4e9


def mjd2iso(mjd: float) -> str:
    epoch = _dt.datetime(1858, 11, 17)
    dt = epoch + _dt.timedelta(days=float(mjd))
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def mjd2date(mjd: float) -> str:
    return mjd2iso(mjd)[:10]


def gmst_deg(mjd: float) -> float:
    """Greenwich mean sidereal time [deg] (IAU 1982 polynomial)."""
    T = (mjd - 51544.5) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (mjd - 51544.5)
            + 0.000387933 * T ** 2 - T ** 3 / 38710000.0)
    return gmst % 360.0


def lst_deg(mjd: float, lon_deg_east: float) -> float:
    """Local mean sidereal time [deg]."""
    return (gmst_deg(mjd) + lon_deg_east) % 360.0


def airmass(ra_deg, dec_deg, mjd, lat_deg, lon_deg_east):
    """Airmass via the Pickering (2002) interpolative formula."""
    alt = altitude_deg(ra_deg, dec_deg, mjd, lat_deg, lon_deg_east)
    h = np.maximum(np.asarray(alt, np.float64), 0.5)
    return 1.0 / np.sin(np.radians(h + 244.0 / (165.0 + 47.0 * h ** 1.1)))


def altitude_deg(ra_deg, dec_deg, mjd, lat_deg, lon_deg_east):
    ha = np.radians(lst_deg(mjd, lon_deg_east) - np.asarray(ra_deg,
                                                            np.float64))
    dec = np.radians(np.asarray(dec_deg, np.float64))
    lat = np.radians(lat_deg)
    sina = (np.sin(lat) * np.sin(dec)
            + np.cos(lat) * np.cos(dec) * np.cos(ha))
    return np.degrees(np.arcsin(np.clip(sina, -1, 1)))


def azimuth_deg(ra_deg, dec_deg, mjd, lat_deg, lon_deg_east):
    ha = np.radians(lst_deg(mjd, lon_deg_east) - np.asarray(ra_deg,
                                                            np.float64))
    dec = np.radians(np.asarray(dec_deg, np.float64))
    lat = np.radians(lat_deg)
    az = np.arctan2(-np.sin(ha),
                    np.tan(dec) * np.cos(lat) - np.sin(lat) * np.cos(ha))
    return np.degrees(az) % 360.0


def jnow2icrs(ra_deg, dec_deg, mjd):
    """Precess apparent (JNOW) coordinates to ICRS/J2000 (rigorous
    rotation with IAU 1976 precession angles; nutation/aberration are
    below the mount-pointing tolerance this is used for —
    reference blackbox.py:6296-6329)."""
    return _precess(ra_deg, dec_deg, mjd, to_icrs=True)


def icrs2jnow(ra_deg, dec_deg, mjd):
    return _precess(ra_deg, dec_deg, mjd, to_icrs=False)


def _precess(ra_deg, dec_deg, mjd, to_icrs: bool):
    T = (mjd - 51544.5) / 36525.0
    zeta = np.radians((2306.2181 * T + 0.30188 * T ** 2
                       + 0.017998 * T ** 3) / 3600.0)
    z = np.radians((2306.2181 * T + 1.09468 * T ** 2
                    + 0.018203 * T ** 3) / 3600.0)
    theta = np.radians((2004.3109 * T - 0.42665 * T ** 2
                        - 0.041833 * T ** 3) / 3600.0)
    cz, sz = np.cos(zeta), np.sin(zeta)
    cZ, sZ = np.cos(z), np.sin(z)
    ct, st = np.cos(theta), np.sin(theta)
    # rotation J2000 -> mean-of-date
    P = np.array([
        [cz * ct * cZ - sz * sZ, -sz * ct * cZ - cz * sZ, -st * cZ],
        [cz * ct * sZ + sz * cZ, -sz * ct * sZ + cz * cZ, -st * sZ],
        [cz * st, -sz * st, ct]])
    if to_icrs:
        P = P.T
    ra = np.radians(np.asarray(ra_deg, np.float64))
    dec = np.radians(np.asarray(dec_deg, np.float64))
    v = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                  np.sin(dec)])
    w = P @ v.reshape(3, -1)
    ra_out = np.degrees(np.arctan2(w[1], w[0])) % 360.0
    dec_out = np.degrees(np.arcsin(np.clip(w[2], -1, 1)))
    if np.isscalar(ra_deg) or np.asarray(ra_deg).ndim == 0:
        return float(ra_out[0]), float(dec_out[0])
    return ra_out.reshape(np.shape(ra_deg)), dec_out.reshape(np.shape(dec_deg))
