"""Known-asteroid cross-match on the transient catalog.

The reference shells out to the external match2SSO package
(reference blackbox.py:31-32, 3258-3275: run_match2SSO on the
light transient catalog, night mode, producing an _sso catalog).  This
module owns the same capability at production fidelity:

* orbital elements ingested straight from MPCORB
  (:mod:`blackbox_tpu_torch.sso.mpcorb`);
* two-body Kepler propagation to the frame epoch;
* Earth position from the truncated VSOP87 series (~5e-7 au,
  :mod:`blackbox_tpu_torch.astro.vsop87`) — the old low-precision Sun moved
  predictions by 20-40";
* TOPOCENTRIC observer (site from settings; up to 8.8"/Delta[au] of
  parallax) and light-time iteration (planetary aberration — the
  astrometric-place convention matching catalog positions);
* (H, G) phase-function magnitudes.

Residual error budget vs full numerical ephemerides: two-body
propagation drift from osculating elements (~1-5"/month for main-belt),
Earth series <0.1", frames <0.3" — comfortably inside the 10" match
radius for elements no older than a few months, same as the reference's
nightly-refreshed MPCORB chain.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blackbox_tpu_torch.astro.vsop87 import earth_heliocentric_j2000
from blackbox_tpu_torch.astro.wcs import haversine

D2R = np.pi / 180.0
OBLIQUITY = 23.4392911 * D2R        # J2000 mean obliquity
K_GAUSS = 0.01720209895             # Gaussian gravitational constant
C_AU_DAY = 173.144632674            # speed of light [au/day]
AU_KM = 149597870.7
TT_MINUS_UT_DAY = 69.0 / 86400.0    # ~2020s; 0.03" on a fast asteroid


@dataclasses.dataclass
class Elements:
    """Heliocentric ecliptic J2000 Keplerian elements at epoch (MJD, TT)."""

    designation: str
    a: float          # semi-major axis [au]
    e: float
    incl: float       # [deg]
    node: float       # longitude of ascending node [deg]
    argper: float     # argument of perihelion [deg]
    M0: float         # mean anomaly at epoch [deg]
    epoch_mjd: float
    H: float = 20.0   # absolute magnitude
    G: float = 0.15   # slope parameter


def kepler_solve(M, e, iters: int = 12):
    """Eccentric anomaly from mean anomaly (Newton, vectorised)."""
    M = np.mod(M + np.pi, 2 * np.pi) - np.pi
    E = np.where(e < 0.8, M, np.pi * np.sign(M) + (M == 0))
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def heliocentric_ecliptic(el: Elements, mjd: float):
    """Position [au] in heliocentric ecliptic J2000 coordinates."""
    n = K_GAUSS / el.a ** 1.5                       # mean motion [rad/day]
    M = el.M0 * D2R + n * (mjd - el.epoch_mjd)
    E = kepler_solve(np.atleast_1d(M), el.e)[0]
    xv = el.a * (np.cos(E) - el.e)
    yv = el.a * np.sqrt(1 - el.e ** 2) * np.sin(E)
    r = np.hypot(xv, yv)
    v = np.arctan2(yv, xv)                          # true anomaly

    w = el.argper * D2R
    O = el.node * D2R
    i = el.incl * D2R
    u = v + w
    x = r * (np.cos(O) * np.cos(u) - np.sin(O) * np.sin(u) * np.cos(i))
    y = r * (np.sin(O) * np.cos(u) + np.cos(O) * np.sin(u) * np.cos(i))
    z = r * np.sin(u) * np.sin(i)
    return np.array([x, y, z]), r


def _gmst_deg(mjd_ut: float) -> float:
    """Greenwich mean sidereal time [deg] (IAU 1982, <0.1s over decades)."""
    d = np.float64(mjd_ut) - 51544.5
    T = d / 36525.0
    return float((280.46061837 + 360.98564736629 * d
                  + 0.000387933 * T * T - T ** 3 / 38710000.0) % 360.0)


def observer_offset_ecliptic(mjd_ut: float, site) -> np.ndarray:
    """Geocenter -> observer vector [au], ecliptic J2000 rectangular.

    site = (lat_deg, lon_east_deg, height_m).  Geodetic -> geocentric
    via the WGS84 flattening; the equator-of-date vs J2000 difference on
    this 4e-5 au vector is <1e-8 au — ignored.
    """
    lat, lon = np.deg2rad(site[0]), float(site[1])
    h_km = (site[2] if len(site) > 2 else 0.0) / 1e3
    f = 1.0 / 298.257223563
    a_km = 6378.137
    cl, sl = np.cos(lat), np.sin(lat)
    C = 1.0 / np.hypot(cl, (1 - f) * sl)
    S = (1 - f) ** 2 * C
    rho_xy = (a_km * C + h_km) * cl / AU_KM
    z = (a_km * S + h_km) * sl / AU_KM
    lst = np.deg2rad(_gmst_deg(mjd_ut) + lon)
    xq, yq, zq = rho_xy * np.cos(lst), rho_xy * np.sin(lst), z
    # equatorial -> ecliptic J2000
    ce, se = np.cos(OBLIQUITY), np.sin(OBLIQUITY)
    return np.array([xq, ce * yq + se * zq, -se * yq + ce * zq])


def _phase_mag(H, G, r, delta, p_obs_to_ast, p_sun_to_ast):
    """V magnitude from the IAU (H, G) phase function."""
    cosa = float(np.dot(p_obs_to_ast, p_sun_to_ast)
                 / max(np.linalg.norm(p_obs_to_ast)
                       * np.linalg.norm(p_sun_to_ast), 1e-12))
    alpha = np.arccos(np.clip(cosa, -1.0, 1.0))
    ta = np.tan(0.5 * alpha)
    phi1 = np.exp(-3.33 * ta ** 0.63)
    phi2 = np.exp(-1.87 * ta ** 1.22)
    pf = max((1 - G) * phi1 + G * phi2, 1e-6)
    return float(H + 5.0 * np.log10(max(r * delta, 1e-12))
                 - 2.5 * np.log10(pf))


def ephemeris(el: Elements, mjd: float, site=None):
    """Astrometric RA/DEC [deg] (J2000, light-time corrected) +
    heliocentric/observer distances [au] and the (H, G) V magnitude.

    mjd is UT of observation; ``site`` (lat, lon_east, height_m) makes
    the prediction topocentric (the reference's match2SSO runs with the
    observatory site from its settings).
    """
    mjd_tt = float(mjd) + TT_MINUS_UT_DAY
    p_obs = earth_heliocentric_j2000(mjd_tt)
    if site is not None:
        p_obs = p_obs + observer_offset_ecliptic(mjd, site)

    # light-time iteration: evaluate the target at t - delta/c
    # (astrometric place — matches catalog positions tied to stars)
    tau = 0.0
    p_ast, r = heliocentric_ecliptic(el, mjd_tt)
    for _ in range(3):
        p_ast, r = heliocentric_ecliptic(el, mjd_tt - tau)
        g = p_ast - p_obs
        delta = float(np.linalg.norm(g))
        tau = delta / C_AU_DAY

    # ecliptic -> equatorial
    ce, se = np.cos(OBLIQUITY), np.sin(OBLIQUITY)
    xq = g[0]
    yq = ce * g[1] - se * g[2]
    zq = se * g[1] + ce * g[2]
    ra = float(np.degrees(np.arctan2(yq, xq)) % 360.0)
    dec = float(np.degrees(np.arcsin(zq / max(delta, 1e-12))))
    mag = _phase_mag(el.H, el.G, r, delta, g, p_ast)
    return ra, dec, float(r), delta, mag


def match_sso(trans_ra, trans_dec, mjd: float, elements: list,
              radius_arcsec: float = 10.0, site=None):
    """Cross-match transient positions against known-object ephemerides.

    Returns (idx_trans, designations, sep_arcsec, pred_mag) arrays.
    """
    if len(elements) == 0 or len(trans_ra) == 0:
        return (np.zeros(0, int), np.zeros(0, "U24"),
                np.zeros(0), np.zeros(0))
    eph = [ephemeris(el, mjd, site=site) for el in elements]
    era = np.array([e[0] for e in eph])
    edec = np.array([e[1] for e in eph])
    emag = np.array([e[4] for e in eph])

    tra = np.asarray(trans_ra, np.float64)
    tdec = np.asarray(trans_dec, np.float64)
    sep = haversine(tra[:, None], tdec[:, None],
                    era[None, :], edec[None, :]) * 3600.0
    j = np.argmin(sep, axis=1)
    s = sep[np.arange(len(tra)), j]
    hit = s < radius_arcsec
    return (np.flatnonzero(hit),
            np.array([elements[k].designation for k in j[hit]], "U24"),
            s[hit], emag[j[hit]])


def annotate_transients(tcols: dict, mjd: float, elements: list,
                        radius_arcsec: float = 10.0, site=None) -> dict:
    """Add SSO columns to a transient-catalog column dict
    (the reference ships a separate _sso catalog; here the designation
    and separation annotate the transient rows directly)."""
    n = len(tcols.get("RA_PSF_D", []))
    desig = np.full(n, "", "U24")
    sep = np.full(n, np.nan, np.float64)
    pmag = np.full(n, np.nan, np.float64)
    idx, names, seps, mags = match_sso(
        tcols.get("RA_PSF_D", []), tcols.get("DEC_PSF_D", []),
        mjd, elements, radius_arcsec, site=site)
    desig[idx] = names
    sep[idx] = seps
    pmag[idx] = mags
    out = dict(tcols)
    out["SSO_DESIG"] = desig
    out["SSO_SEP"] = sep.astype(np.float32)
    out["SSO_MAG"] = pmag.astype(np.float32)
    return out
