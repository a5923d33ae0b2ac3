"""Batched weighted polynomial least squares (port of
:mod:`blackbox_tpu.ops.polyfit`).

One batched normal-equation solve over all channels; fits use a
[-1, 1]-normalised abscissa so a deg-7 Vandermonde stays conditioned in
float32.  The solve is ``torch.linalg.solve`` in float32 (LU with
partial pivoting, like ``jnp.linalg.solve``).
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.utils.timing import count


def vander_norm(x, deg: int, x0: float, x1: float):
    """Vandermonde matrix of ``x`` rescaled from [x0, x1] to [-1, 1]."""
    t = (2.0 * (x - x0) / (x1 - x0) - 1.0).to(torch.float32)
    return t[..., None] ** torch.arange(deg + 1, dtype=torch.float32,
                                        device=t.device)


def polyfit_w(x, y, w, deg: int, x0: float, x1: float, rcond: float = 1e-6):
    """Weighted polynomial fit; batched over leading dims of y/w.

    x : (..., N) or (N,) abscissa, mapped from [x0, x1] to [-1, 1]
    y, w : (..., N), w = 0 excluded.
    Returns coefficients (..., deg+1) in the normalised domain.
    """
    V = vander_norm(x, deg, x0, x1)                         # (..., N, D)
    A = torch.einsum("...ni,...n,...nj->...ij", V, w, V)    # (..., D, D)
    b = torch.einsum("...ni,...n->...i", V, w * y)          # (..., D)
    # Tikhonov ridge for rank-deficient (all-masked) batches
    D = deg + 1
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    A = A + rcond * torch.eye(D, dtype=A.dtype, device=A.device) * (
        tr[..., None, None] / D + 1e-20)
    # the solve reads its error flags on the host
    count("host.reads")
    return torch.linalg.solve(A, b[..., None])[..., 0]


def polyval_norm(coef, x, x0, x1):
    """Evaluate coefficients from :func:`polyfit_w` at ``x``."""
    V = vander_norm(x, coef.shape[-1] - 1, x0, x1)
    return torch.einsum("...ni,...i->...n", V, coef)


def polyfit_reject(x, y, w, deg: int, err, x0: float, x1: float,
                   nreject_sigma: float = 3.0, reject_iters: int = 3):
    """Iterative fit-and-reject: after each fit, points with
    ``|fit - y| > nreject_sigma * err`` lose their weight.
    Returns (coefficients, final weights, fitted values)."""
    fit = torch.zeros_like(y)
    coef = None
    for _ in range(reject_iters):
        coef = polyfit_w(x, y, w, deg, x0, x1)
        fit = polyval_norm(coef, x, x0, x1)
        w = w * (torch.abs(fit - y) <= nreject_sigma * err)
    return coef, w, fit
