"""Non-linearity correction (port of :mod:`blackbox_tpu.ops.nonlin`).

The per-channel fractional correction is a polynomial in ADU over the
normalised domain [0, adu_max]; :func:`convert_reference_splines` (a
host numpy copy of the JAX package's) fits it to the reference's
pickled splines when the driver's settings name such a file.
"""

from __future__ import annotations

import numpy as np
import torch


def nonlin_correct(chan_data, gains, coeffs, adu_max: float = 50000.0):
    """Apply the relative non-linearity correction per channel.

    chan_data : (C, ych, xch) [e-]
    gains     : (C,) e-/ADU (to evaluate the curve in ADU)
    coeffs    : (C, D) polynomial coefficients of the fractional
                correction over the normalised ADU domain [0, adu_max]

    data_corrected = data / (1 + frac(data_adu)) below the ADU cap.
    """
    C = chan_data.shape[0]
    if coeffs.dim() != 2 or coeffs.shape[0] != C:
        raise ValueError(f"nonlin_correct: coefficients of shape "
                         f"{tuple(coeffs.shape)} for {C} channels; (C, D) "
                         "expected")
    adu = chan_data / gains.to(chan_data.dtype)[:, None, None]
    # vander_norm's abscissa; the powers one at a time, in the einsum's
    # order, so no (C, N, D) Vandermonde cube is materialised
    t = 2.0 * adu / adu_max - 1.0
    frac = coeffs[:, 0, None, None] * t ** 0
    for d in range(1, coeffs.shape[1]):
        frac = frac + coeffs[:, d, None, None] * t ** d
    corr = chan_data / (1.0 + frac)
    return torch.where(adu < adu_max, corr, chan_data)


def convert_reference_splines(path_or_splines, adu_max: float = 50000.0,
                              tol: float = 5e-5, max_degree: int = 15):
    """Reference ``nonlin_splines_*.pkl`` -> (C, D) poly coefficients.

    The reference ships the fractional correction as a pickled list of
    per-channel scipy spline callables evaluated in ADU below 50k
    (reference blackbox.py:7394-7437, set_blackbox.py:202).  On
    device the curve is a polynomial over the normalised ADU domain
    (:func:`nonlin_correct`); this host-side converter samples each
    spline densely and fits the lowest degree whose worst absolute
    error in the FRACTIONAL correction is below ``tol`` (default half
    the 1e-4 drop-in-parity budget).

    path_or_splines : pickle path (unpickling scipy splines requires
        scipy importable) or an already-loaded list of callables
    Returns (coeffs float32 (C, D), max_abs_err float).
    """
    if isinstance(path_or_splines, (str, bytes)) or hasattr(
            path_or_splines, "__fspath__"):
        import pickle
        from blackbox_tpu_torch.io.storage import get_backend
        raw = get_backend(str(path_or_splines)).read_bytes(
            str(path_or_splines))
        splines = pickle.loads(raw)
    else:
        splines = path_or_splines

    adu = np.linspace(0.0, adu_max, 4096)
    t = 2.0 * adu / adu_max - 1.0                 # vander_norm domain
    frac = np.stack([np.asarray(s(adu), np.float64) for s in splines])

    best = None
    for deg in range(3, max_degree + 1):
        V = t[:, None] ** np.arange(deg + 1)
        coef, *_ = np.linalg.lstsq(V, frac.T, rcond=None)
        err = float(np.max(np.abs(V @ coef - frac.T)))
        if best is None or err < best[1]:
            best = (coef.T, err)
        if err < tol:
            break
    coeffs, err = best
    if err >= 10 * tol:
        raise ValueError(
            f"spline curves not polynomial-representable: max |dfrac| "
            f"{err:.2e} at degree {max_degree} (tol {tol:.0e})")
    return coeffs.astype(np.float32), err


def convert_reference_splines_to_npy(src: str, dst: str, **kw):
    """One-shot file converter: reference .pkl -> framework .npy."""
    coeffs, err = convert_reference_splines(src, **kw)
    np.save(dst, coeffs)
    return coeffs, err
