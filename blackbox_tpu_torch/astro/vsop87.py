"""Truncated VSOP87 Earth ephemeris (~1" accuracy).

The low-precision solar series in :mod:`blackbox_tpu_torch.astro.ephem` is
good to ~0.01 deg — fine for airmass/moon keywords, but an Earth
position that coarse moves a main-belt asteroid prediction by 20-40",
which defeats the <10" known-object cross-match the reference gets from
its external match2SSO package (reference blackbox.py:3258-3275).
This module carries the classic truncated VSOP87 series for Earth
(Bretagnon & Francou 1988; the truncation popularised by Meeus,
"Astronomical Algorithms" ch. 32, stated accuracy ~1" in longitude over
several millennia around J2000), giving the heliocentric position to
~5e-7 au — a <0.1" contribution at 1 au geocentric distance.

Validation: the test suite anchors the derived apparent solar longitude
against published equinox instants (known to the minute; the Sun moves
2.5"/min, so each anchor checks the series at the few-arcsec level).
"""

from __future__ import annotations

import numpy as np

# Each row: (A [1e-8 rad or 1e-8 au], B [rad], C [rad/millennium]);
# series value = sum A*cos(B + C*tau), tau = Julian millennia TDB from
# J2000.  L/B are ecliptic-of-date longitude/latitude, R the radius.
_L0 = [
    (175347046.0, 0.0, 0.0),
    (3341656.0, 4.6692568, 6283.0758500),
    (34894.0, 4.6261, 12566.1517),
    (3497.0, 2.7441, 5753.3849),
    (3418.0, 2.8289, 3.5231),
    (3136.0, 3.6277, 77713.7715),
    (2676.0, 4.4181, 7860.4194),
    (2343.0, 6.1352, 3930.2097),
    (1324.0, 0.7425, 11506.7698),
    (1273.0, 2.0371, 529.6910),
    (1199.0, 1.1096, 1577.3435),
    (990.0, 5.233, 5884.927),
    (902.0, 2.045, 26.298),
    (857.0, 3.508, 398.149),
    (780.0, 1.179, 5223.694),
    (753.0, 2.533, 5507.553),
    (505.0, 4.583, 18849.228),
    (492.0, 4.205, 775.523),
    (357.0, 2.920, 0.067),
    (317.0, 5.849, 11790.629),
    (284.0, 1.899, 796.298),
    (271.0, 0.315, 10977.079),
    (243.0, 0.345, 5486.778),
    (206.0, 4.806, 2544.314),
    (205.0, 1.869, 5573.143),
    (202.0, 2.458, 6069.777),
    (156.0, 0.833, 213.299),
    (132.0, 3.411, 2942.463),
    (126.0, 1.083, 20.775),
    (115.0, 0.645, 0.980),
    (103.0, 0.636, 4694.003),
    (102.0, 0.976, 15720.839),
    (102.0, 4.267, 7.114),
    (99.0, 6.21, 2146.17),
    (98.0, 0.68, 155.42),
    (86.0, 5.98, 161000.69),
    (85.0, 1.30, 6275.96),
    (85.0, 3.67, 71430.70),
    (80.0, 1.81, 17260.15),
    (79.0, 3.04, 12036.46),
    (75.0, 1.76, 5088.63),
    (74.0, 3.50, 3154.69),
    (74.0, 4.68, 801.82),
    (70.0, 0.83, 9437.76),
    (62.0, 3.98, 8827.39),
    (61.0, 1.82, 7084.90),
    (57.0, 2.78, 6286.60),
    (56.0, 4.39, 14143.50),
    (56.0, 3.47, 6279.55),
    (52.0, 0.19, 12139.55),
    (52.0, 1.33, 1748.02),
    (51.0, 0.28, 5856.48),
    (49.0, 0.49, 1194.45),
    (41.0, 5.37, 8429.24),
    (41.0, 2.40, 19651.05),
    (39.0, 6.17, 10447.39),
    (37.0, 6.04, 10213.29),
    (37.0, 2.57, 1059.38),
    (36.0, 1.71, 2352.87),
    (36.0, 1.78, 6812.77),
    (33.0, 0.59, 17789.85),
    (30.0, 0.44, 83996.85),
    (30.0, 2.74, 1349.87),
    (25.0, 3.16, 4690.48),
]
_L1 = [
    (628331966747.0, 0.0, 0.0),
    (206059.0, 2.678235, 6283.075850),
    (4303.0, 2.6351, 12566.1517),
    (425.0, 1.590, 3.523),
    (119.0, 5.796, 26.298),
    (109.0, 2.966, 1577.344),
    (93.0, 2.59, 18849.23),
    (72.0, 1.14, 529.69),
    (68.0, 1.87, 398.15),
    (67.0, 4.41, 5507.55),
    (59.0, 2.89, 5223.69),
    (56.0, 2.17, 155.42),
    (45.0, 0.40, 796.30),
    (36.0, 0.47, 775.52),
    (29.0, 2.65, 7.11),
    (21.0, 5.34, 0.98),
    (19.0, 1.85, 5486.78),
    (19.0, 4.97, 213.30),
    (17.0, 2.99, 6275.96),
    (16.0, 0.03, 2544.31),
    (16.0, 1.43, 2146.17),
    (15.0, 1.21, 10977.08),
    (12.0, 2.83, 1748.02),
    (12.0, 3.26, 5088.63),
    (12.0, 5.27, 1194.45),
    (12.0, 2.08, 4694.00),
    (11.0, 0.77, 553.57),
    (10.0, 1.30, 6286.60),
    (10.0, 4.24, 1349.87),
    (9.0, 2.70, 242.73),
    (9.0, 5.64, 951.72),
    (8.0, 5.30, 2352.87),
    (6.0, 2.65, 9437.76),
    (6.0, 4.67, 4690.48),
]
_L2 = [
    (52919.0, 0.0, 0.0),
    (8720.0, 1.0721, 6283.0758),
    (309.0, 0.867, 12566.152),
    (27.0, 0.05, 3.52),
    (16.0, 5.19, 26.30),
    (16.0, 3.68, 155.42),
    (10.0, 0.76, 18849.23),
    (9.0, 2.06, 77713.77),
    (7.0, 0.83, 775.52),
    (5.0, 4.66, 1577.34),
    (4.0, 1.03, 7.11),
    (4.0, 3.44, 5573.14),
    (3.0, 5.14, 796.30),
    (3.0, 6.05, 5507.55),
    (3.0, 1.19, 242.73),
    (3.0, 6.12, 529.69),
    (3.0, 0.31, 398.15),
    (3.0, 2.28, 553.57),
    (2.0, 4.38, 5223.69),
    (2.0, 3.75, 0.98),
]
_L3 = [
    (289.0, 5.844, 6283.076),
    (35.0, 0.0, 0.0),
    (17.0, 5.49, 12566.15),
    (3.0, 5.20, 155.42),
    (1.0, 4.72, 3.52),
    (1.0, 5.30, 18849.23),
    (1.0, 5.97, 242.73),
]
_L4 = [
    (114.0, 3.142, 0.0),
    (8.0, 4.13, 6283.08),
    (1.0, 3.84, 12566.15),
]
_L5 = [
    (1.0, 3.14, 0.0),
]
_B0 = [
    (280.0, 3.199, 84334.662),
    (102.0, 5.422, 5507.553),
    (80.0, 3.88, 5223.69),
    (44.0, 3.70, 2352.87),
    (32.0, 4.00, 1577.34),
]
_B1 = [
    (9.0, 3.90, 5507.55),
    (6.0, 1.73, 5223.69),
]
_R0 = [
    (100013989.0, 0.0, 0.0),
    (1670700.0, 3.0984635, 6283.0758500),
    (13956.0, 3.05525, 12566.15170),
    (3084.0, 5.1985, 77713.7715),
    (1628.0, 1.1739, 5753.3849),
    (1576.0, 2.8469, 7860.4194),
    (925.0, 5.453, 11506.770),
    (542.0, 4.564, 3930.210),
    (472.0, 3.661, 5884.927),
    (346.0, 0.964, 5507.553),
    (329.0, 5.900, 5223.694),
    (307.0, 0.299, 5573.143),
    (243.0, 4.273, 11790.629),
    (212.0, 5.847, 1577.344),
    (186.0, 5.022, 10977.079),
    (175.0, 3.012, 18849.228),
    (110.0, 5.055, 5486.778),
    (98.0, 0.89, 6069.78),
    (86.0, 5.69, 15720.84),
    (86.0, 1.27, 161000.69),
    (65.0, 0.27, 17260.15),
    (63.0, 0.92, 529.69),
    (57.0, 2.01, 83996.85),
    (56.0, 5.24, 71430.70),
    (49.0, 3.25, 2544.31),
    (47.0, 2.58, 775.52),
    (45.0, 5.54, 9437.76),
    (43.0, 6.01, 6275.96),
    (39.0, 5.36, 4694.00),
    (38.0, 2.39, 8827.39),
    (37.0, 0.83, 19651.05),
    (37.0, 4.90, 12139.55),
    (36.0, 1.67, 12036.46),
    (35.0, 1.84, 2942.46),
    (33.0, 0.24, 7084.90),
    (32.0, 0.18, 5088.63),
    (32.0, 1.78, 398.15),
    (28.0, 1.21, 6286.60),
    (28.0, 1.90, 6279.55),
    (26.0, 4.59, 10447.39),
]
_R1 = [
    (103019.0, 1.107490, 6283.075850),
    (1721.0, 1.0644, 12566.1517),
    (702.0, 3.142, 0.0),
    (32.0, 1.02, 18849.23),
    (31.0, 2.84, 5507.55),
    (25.0, 1.32, 5223.69),
    (18.0, 1.42, 1577.34),
    (10.0, 5.91, 10977.08),
    (9.0, 1.42, 6275.96),
    (9.0, 0.27, 5486.78),
]
_R2 = [
    (4359.0, 5.7846, 6283.0758),
    (124.0, 5.579, 12566.152),
    (12.0, 3.14, 0.0),
    (9.0, 3.63, 77713.77),
    (6.0, 1.87, 5573.14),
    (3.0, 5.47, 18849.23),
]
_R3 = [
    (145.0, 4.273, 6283.076),
    (7.0, 3.92, 12566.15),
]
_R4 = [
    (4.0, 2.56, 6283.08),
]


def _series(terms, tau):
    a = np.asarray([t[0] for t in terms])
    b = np.asarray([t[1] for t in terms])
    c = np.asarray([t[2] for t in terms])
    return np.sum(a * np.cos(b + c * tau))


def earth_lbr_date(mjd_tt) -> tuple:
    """Heliocentric ecliptic (L [rad], B [rad], R [au]) OF DATE."""
    tau = (np.float64(mjd_tt) - 51544.5) / 365250.0
    L = (_series(_L0, tau) + tau * (_series(_L1, tau)
         + tau * (_series(_L2, tau) + tau * (_series(_L3, tau)
         + tau * (_series(_L4, tau) + tau * _series(_L5, tau)))))) * 1e-8
    B = (_series(_B0, tau) + tau * _series(_B1, tau)) * 1e-8
    R = (_series(_R0, tau) + tau * (_series(_R1, tau)
         + tau * (_series(_R2, tau) + tau * (_series(_R3, tau)
         + tau * _series(_R4, tau))))) * 1e-8
    return float(L % (2 * np.pi)), float(B), float(R)


def earth_heliocentric_j2000(mjd_tt) -> np.ndarray:
    """Earth heliocentric position [au], ecliptic J2000 rectangular.

    VSOP87D longitudes refer to the mean ecliptic/equinox OF DATE; the
    J2000-frame longitude subtracts the accumulated general precession
    (1.397 deg/century, Meeus 32.3 — the residual frame-tie and the
    latitude cross-term are <0.1").
    """
    L, B, R = earth_lbr_date(mjd_tt)
    T = (np.float64(mjd_tt) - 51544.5) / 36525.0
    Lj = L - np.deg2rad(1.397 * T + 0.00031 * T * T)
    cb = np.cos(B)
    return R * np.array([cb * np.cos(Lj), cb * np.sin(Lj), np.sin(B)])


def nutation_longitude_arcsec(mjd) -> float:
    """Nutation in longitude [arcsec], leading terms (~0.3" accuracy)."""
    d = np.float64(mjd) - 51544.5
    T = d / 36525.0
    Om = np.deg2rad(125.04452 - 1934.136261 * T)
    Ls = np.deg2rad(280.4665 + 36000.7698 * T)
    Lm = np.deg2rad(218.3165 + 481267.8813 * T)
    return float(-17.20 * np.sin(Om) - 1.32 * np.sin(2 * Ls)
                 - 0.23 * np.sin(2 * Lm) + 0.21 * np.sin(2 * Om))


def sun_apparent_longitude_date(mjd_ut) -> float:
    """Apparent geocentric ecliptic longitude of the Sun [deg], TRUE
    equinox of date (geometric of-date longitude + pi, plus nutation in
    longitude, minus ~20.5" annual aberration) — the quantity that is
    0/90/180/270 deg exactly at the equinoxes and solstices.  Used by
    the anchor tests that validate the Earth series."""
    # the series runs on TT; TT-UT ~ 69 s in the 2020s moves the Sun
    # by ~2.9" — a visible bias against minute-accurate equinox anchors
    L, B, R = earth_lbr_date(np.float64(mjd_ut) + 69.0 / 86400.0)
    lam = np.degrees((L + np.pi) % (2 * np.pi))
    lam += nutation_longitude_arcsec(mjd_ut) / 3600.0
    lam -= 20.4898 / 3600.0 / R          # annual aberration
    return float(lam % 360.0)
