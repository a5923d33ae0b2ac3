"""Non-linearity correction (port of :mod:`blackbox_tpu.ops.nonlin`).

The per-channel fractional correction is a polynomial in ADU over the
normalised domain [0, adu_max] (the JAX package's converter fits it to
the reference's pickled splines on the host; that converter goes with
the driver, which is the only caller of it).
"""

from __future__ import annotations

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
