"""Synthetic raw science frames generated on the device (port of
:mod:`blackbox_tpu.synth.device`).

At full MeerLICHT size a frame is 16 x 5280 x 1320 float32 (446 MB):
building it on the host would cost seconds of numpy work and a
transfer, so it is built where it is reduced.  Star field: scattered
deltas convolved with a Moffat PSF through ``torch.fft``; sky + Poisson
noise by the normal approximation; vignetting and pixel response;
cosmic-ray hits; a diagonal satellite trail; per-channel bias level
and read noise.  Randomness comes from the caller's ``torch.Generator``
(the frames do not reproduce ``jax.random``'s bits).
"""

from __future__ import annotations

import numpy as np
import torch

from blackbox_tpu_torch.config import GAIN, SATLEVEL, get_par
from blackbox_tpu_torch.core.geometry import CCDGeometry


def moffat_kernel(shape, fwhm: float = 3.0, beta: float = 2.5,
                  device=None):
    """Centred Moffat PSF image of the full frame size (for FFT conv)."""
    H, W = shape
    alpha = fwhm / (2 * np.sqrt(2 ** (1 / beta) - 1))
    y = torch.arange(H, dtype=torch.float32, device=device)
    x = torch.arange(W, dtype=torch.float32, device=device)
    # wrapped radii so the kernel is centred at (0, 0) for FFT use
    yy = torch.minimum(y, H - y)[:, None]
    xx = torch.minimum(x, W - x)[None, :]
    r2 = yy * yy + xx * xx
    k = (beta - 1) / (np.pi * alpha ** 2) * (1 + r2 / alpha ** 2) ** (-beta)
    return k / torch.sum(k)


def make_science_device(gen: torch.Generator, geom: CCDGeometry,
                        nstars: int = 4000, sky_e: float = 300.0,
                        fwhm: float = 3.0, ncosmics: int = 800,
                        trail: bool = True, nsat: int = 20,
                        flux_range=(2e3, 2e5), telescope: str = "ML1",
                        stars=None):
    """Synthetic raw science frame on ``gen``'s device.

    ``stars`` — optional (x, y, flux [e-]) of every point source, in
    place of the ``nstars`` random stars and ``nsat`` saturated ones
    (a later visit of the same field: the same stars moved and scaled,
    plus new sources).  Each source is a delta at its integer pixel
    convolved with the Moffat PSF.

    Returns (chan_data, os_vert, os_hori) float32 stacks shaped like
    ``geom.split_raw`` output, plus a truth dict (star x, y, flux).
    """
    dev = gen.device
    C = geom.n_chan
    H, W = geom.red_shape

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    gain = torch.tensor(np.resize(np.asarray(get_par(GAIN, telescope),
                                             np.float32), C), device=dev)
    satlevel = torch.tensor(np.resize(np.asarray(get_par(SATLEVEL, telescope),
                                                 np.float32), C), device=dev)

    # ---- star field: scattered deltas -> FFT Moffat convolution ----
    if stars is not None:
        xs, ys, fluxes = (torch.as_tensor(v, dtype=torch.float32,
                                          device=dev) for v in stars)
    else:
        xs = uniform(nstars, 8.0, W - 8.0)
        ys = uniform(nstars, 8.0, H - 8.0)
        fluxes = torch.exp(uniform(nstars, float(np.log(flux_range[0])),
                                   float(np.log(flux_range[1]))))
        if nsat:
            xs = torch.cat([xs, uniform(nsat, 20.0, W - 20.0)])
            ys = torch.cat([ys, uniform(nsat, 20.0, H - 20.0)])
            fluxes = torch.cat([fluxes,
                                torch.full((nsat,), 5e7, device=dev)])

    delta = torch.zeros((H, W), dtype=torch.float32, device=dev)
    iy = torch.clamp(ys.long(), 0, H - 1)
    ix = torch.clamp(xs.long(), 0, W - 1)
    delta.index_put_((iy, ix), fluxes, accumulate=True)
    psf = moffat_kernel((H, W), fwhm, device=dev)
    data_e = torch.fft.irfft2(torch.fft.rfft2(delta) * torch.fft.rfft2(psf),
                              s=(H, W))
    del delta, psf
    data_e = torch.clamp(data_e, min=0.0) + sky_e

    # vignetting + 1 % pixel response
    yv = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2) / (H / 2)
    xv = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2) / (W / 2)
    data_e *= (1.0 - 0.06 * (yv[:, None] ** 2 + xv[None, :] ** 2))
    data_e *= 1.0 + 0.01 * normal((H, W))

    # Poisson via the normal approximation
    data_e += torch.sqrt(torch.clamp(data_e, min=0.0)) * normal((H, W))

    # cosmic rays: 1-px deltas (+ a 0.6x neighbour for 2/3 of them)
    cy = torch.randint(4, H - 4, (ncosmics,), generator=gen, device=dev)
    cx = torch.randint(4, W - 4, (ncosmics,), generator=gen, device=dev)
    camp = uniform(ncosmics, 3000.0, 40000.0)
    data_e.index_put_((cy, cx), camp, accumulate=True)
    second = torch.arange(ncosmics, device=dev) % 3 != 0
    data_e.index_put_((cy, cx + 1), torch.where(second, 0.6 * camp, 0.0),
                      accumulate=True)

    # satellite trail: gaussian-profile diagonal line
    if trail:
        yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        x0, y0, x1, y1 = 0.1 * W, 0.2 * H, 0.9 * W, 0.8 * H
        nx_, ny_ = y1 - y0, -(x1 - x0)
        nrm = float(np.hypot(nx_, ny_))
        d = torch.abs((xx - x0) * (nx_ / nrm) + (yy - y0) * (ny_ / nrm))
        sig = max(fwhm / 2.355, 0.8)
        data_e += 4000.0 * torch.exp(-0.5 * (d / sig) ** 2)
        del d

    # ---- to raw channel stacks with overscan + bias structure ----
    chan_adu = geom.disassemble(data_e) / gain[:, None, None]
    del data_e
    chan_adu = torch.minimum(chan_adu, satlevel[:, None, None] * 1.05)
    bias_level = uniform(C, 7000.0, 8000.0)
    rdnoise_adu = uniform(C, 4.0, 6.0)

    def with_bias(shape3):
        return (bias_level[:, None, None]
                + rdnoise_adu[:, None, None] * normal(shape3))

    chan_data = chan_adu + with_bias(chan_adu.shape)
    os_vert = with_bias((C, geom.dy, geom.os_vert_width))
    os_hori = with_bias((C, geom.os_hori_height, geom.dx))
    truth = {"x": xs, "y": ys, "flux": fluxes}
    return chan_data, os_vert, os_hori, truth
