"""Aperture photometry over a fixed-capacity catalog (port of
:mod:`blackbox_tpu.ops.photometry`).

Each slot's window comes from :func:`gather_slot_windows` (the CUDA
gather kernel on the card); fluxes are fractional-coverage-weighted
circle sums, errors come from the background-STD map plus source
Poisson noise (data in e-, gain 1).
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.ops.windows import gather_slot_windows


def aperture_photometry(image_bksub, bkg_std, xs, ys, radii,
                        window: int = 32, n_active=None):
    """Sum fluxes in circular apertures.

    image_bksub : (H, W) background-subtracted image [e-]
    bkg_std     : (H, W) background STD map
    xs, ys      : (N,) centroids (0-based pixel coords)
    radii       : sequence of aperture radii [pix] (length R)
    window      : cutout size (>= 2*max(radii)+2)
    n_active    : live slot count; slots past it see zero windows

    Returns (flux (N, R), fluxerr (N, R)).
    """
    H, W = image_bksub.shape
    dev = image_bksub.device
    half = window // 2
    radii = torch.tensor(radii, dtype=torch.float32, device=dev)
    x0 = torch.clamp(torch.round(xs).to(torch.int32) - half, 0, W - window)
    y0 = torch.clamp(torch.round(ys).to(torch.int32) - half, 0, H - window)
    dyx = torch.arange(window, dtype=torch.float32, device=dev)

    cut, sd = gather_slot_windows((image_bksub, bkg_std), y0, x0, window,
                                  n_active=n_active)
    var = sd ** 2
    dy = dyx[None, :] + y0.to(torch.float32)[:, None] - ys[:, None]
    dx = dyx[None, :] + x0.to(torch.float32)[:, None] - xs[:, None]
    r = torch.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2)  # (N, w, w)
    # fractional coverage: linear ramp across the aperture edge
    covg = torch.clamp(radii[None, :, None, None] + 0.5 - r[:, None],
                       0.0, 1.0)                               # (N, R, w, w)
    flux = torch.sum(covg * cut[:, None], dim=(2, 3))
    err2 = torch.sum(covg * var[:, None], dim=(2, 3)) \
        + torch.clamp(flux, min=0.0)
    return flux, torch.sqrt(err2)
