"""Sun and Moon ephemerides (low precision, <~0.01-0.2 deg).

Replaces pyephem in the reference's header engine and night scheduler
(sun/moon altitudes, moon illumination/separation, sunrise/sunset —
reference blackbox.py:403-412, 5942-6001).  Algorithms are the
standard truncated series from Meeus, "Astronomical Algorithms": ample for
observability keywords and twilight timing.
"""

from __future__ import annotations

import numpy as np

from blackbox_tpu_torch.astro.time import lst_deg, altitude_deg

D2R = np.pi / 180.0


def sun_radec(mjd):
    """Apparent geocentric RA/DEC of the Sun [deg]."""
    n = np.asarray(mjd, np.float64) - 51544.5
    L = (280.460 + 0.9856474 * n) % 360.0          # mean longitude
    g = np.radians((357.528 + 0.9856003 * n) % 360.0)
    lam = np.radians(L + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))
    eps = np.radians(23.439 - 0.0000004 * n)
    ra = np.degrees(np.arctan2(np.cos(eps) * np.sin(lam),
                               np.cos(lam))) % 360.0
    dec = np.degrees(np.arcsin(np.sin(eps) * np.sin(lam)))
    return ra, dec


def sun_distance_au(mjd):
    """Earth-Sun distance [au] (low-precision series)."""
    n = np.asarray(mjd, np.float64) - 51544.5
    g = np.radians((357.528 + 0.9856003 * n) % 360.0)
    return 1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2 * g)


def moon_radec(mjd):
    """Geocentric RA/DEC of the Moon [deg] (truncated series, ~0.3 deg)."""
    T = (np.asarray(mjd, np.float64) - 51544.5) / 36525.0
    Lp = (218.3164477 + 481267.88123421 * T) % 360.0   # mean longitude
    D = np.radians((297.8501921 + 445267.1114034 * T) % 360.0)
    M = np.radians((357.5291092 + 35999.0502909 * T) % 360.0)
    Mp = np.radians((134.9633964 + 477198.8675055 * T) % 360.0)
    F = np.radians((93.2720950 + 483202.0175233 * T) % 360.0)

    dL = (6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
          + 0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp)
          - 0.185116 * np.sin(M) - 0.114332 * np.sin(2 * F)
          + 0.058793 * np.sin(2 * D - 2 * Mp)
          + 0.057066 * np.sin(2 * D - M - Mp)
          + 0.053322 * np.sin(2 * D + Mp)
          + 0.045758 * np.sin(2 * D - M))
    lam = np.radians(Lp + dL)
    beta = np.radians(5.128122 * np.sin(F) + 0.280602 * np.sin(Mp + F)
                      + 0.277693 * np.sin(Mp - F)
                      + 0.173237 * np.sin(2 * D - F))
    eps = np.radians(23.4393 - 0.013 * T)
    sl, cl = np.sin(lam), np.cos(lam)
    sb, cb = np.sin(beta), np.cos(beta)
    ra = np.degrees(np.arctan2(sl * cb * np.cos(eps) - sb * np.sin(eps),
                               cl * cb)) % 360.0
    dec = np.degrees(np.arcsin(sb * np.cos(eps)
                               + cb * np.sin(eps) * sl))
    return ra, dec


def moon_illumination(mjd):
    """Illuminated fraction of the Moon's disk (0..1)."""
    sra, sdec = sun_radec(mjd)
    mra, mdec = moon_radec(mjd)
    cpsi = (np.sin(np.radians(sdec)) * np.sin(np.radians(mdec))
            + np.cos(np.radians(sdec)) * np.cos(np.radians(mdec))
            * np.cos(np.radians(sra - mra)))
    psi = np.arccos(np.clip(cpsi, -1, 1))
    # phase angle ~ pi - elongation for a distant sun
    return (1 + np.cos(np.pi - psi)) / 2.0


def sun_altitude(mjd, lat, lon_east):
    ra, dec = sun_radec(mjd)
    return altitude_deg(ra, dec, mjd, lat, lon_east)


def moon_altitude(mjd, lat, lon_east):
    ra, dec = moon_radec(mjd)
    return altitude_deg(ra, dec, mjd, lat, lon_east)


def horizon_dip_deg(height_m: float) -> float:
    """Apparent sunrise horizon altitude for an elevated observer.

    The reference's ``adjust_horizon`` (blackbox.py:488-503): −34′ for
    atmospheric refraction (ephem tracks the top of the Sun, so no
    solar-radius term) minus the geometric dip arccos(R/(R+h)).
    """
    R = 6.3781e6
    return -34.0 / 60.0 - np.degrees(np.arccos(R / (R + max(height_m, 0.0))))


def sun_crossing(mjd_start: float, lat: float, lon_east: float,
                 alt_deg: float = -10.0, rising: bool = True,
                 max_days: float = 1.5) -> float:
    """First MJD after ``mjd_start`` when the Sun crosses ``alt_deg``.

    The reference schedules night mode until 1 h past sunrise with an
    adjustable horizon (blackbox.py:488-503); bisection over 1-minute
    samples gives the same to <1 s.
    """
    ts = np.arange(mjd_start, mjd_start + max_days, 1.0 / 1440.0)
    alts = sun_altitude(ts, lat, lon_east)
    above = alts > alt_deg
    for i in range(1, len(ts)):
        crossed = (above[i] and not above[i - 1]) if rising else \
            (not above[i] and above[i - 1])
        if crossed:
            lo, hi = ts[i - 1], ts[i]
            for _ in range(20):
                mid = 0.5 * (lo + hi)
                up = sun_altitude(mid, lat, lon_east) > alt_deg
                if up == rising:
                    hi = mid
                else:
                    lo = mid
            return 0.5 * (lo + hi)
    raise ValueError("no crossing found")
