"""The benchmark's inputs, made on the device from the run's seed.

A frozen copy of the port's synthetic raw frame (a Moffat star field
through the FFT, sky and Poisson noise by the normal approximation,
vignetting and pixel response, cosmic-ray hits, a diagonal satellite
trail, per-channel gains, saturation, bias levels and read noise), with
one change: a star's flux is shared bilinearly among the four pixels
around its position, so a field moved by a sub-pixel registration is
the same field.  Nothing here imports the program: the geometry is the
reference's copy, and gains and saturation levels come from the
configuration's file.

Every random draw comes from a ``torch.Generator`` seeded from
``(seed, stream)`` through numpy's ``SeedSequence``, so the same seed
gives the same frames in any order.  Every seed gives the same numbers
of stars, cosmics and transients, and the same star fluxes, cosmic
amplitudes, bias levels and read noises (evenly spaced), at other
places and in other channels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.core import geometry


def generator(seed: int, *stream: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` for the named substream of ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *stream])
    value = int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(value)


def moffat_kernel(shape, fwhm: float, beta: float = 2.5, device=None):
    """Centred Moffat PSF image of the full frame size (for FFT conv)."""
    H, W = shape
    alpha = fwhm / (2 * np.sqrt(2 ** (1 / beta) - 1))
    y = torch.arange(H, dtype=torch.float32, device=device)
    x = torch.arange(W, dtype=torch.float32, device=device)
    yy = torch.minimum(y, H - y)[:, None]
    xx = torch.minimum(x, W - x)[None, :]
    r2 = yy * yy + xx * xx
    k = (beta - 1) / (np.pi * alpha ** 2) * (1 + r2 / alpha ** 2) ** (-beta)
    return k / torch.sum(k)


def _uniform(gen, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def _spaced(gen, n: int, lo: float, hi: float) -> torch.Tensor:
    """``n`` values evenly spaced over [lo, hi], in an order drawn from
    ``gen``: every seed the same set, placed anew."""
    v = torch.linspace(lo, hi, n, device=gen.device) if n > 1 else \
        torch.full((n,), 0.5 * (lo + hi), device=gen.device)
    return v[torch.randperm(n, generator=gen, device=gen.device)]


def field_stars(gen, scene, field: dict, margin: float = 20.0):
    """(x, y, flux [e-]) of a traffic file's ``field``: ``stars`` stars,
    their fluxes spaced evenly in log over ``flux_e``, and ``saturated``
    ones of ``saturated_flux_e``, at random positions."""
    H, W = scene.geom.red_shape
    nstars, nsat = field["stars"], field["saturated"]
    lo, hi = field["flux_e"]
    xs = _uniform(gen, nstars + nsat, margin, W - margin)
    ys = _uniform(gen, nstars + nsat, margin, H - margin)
    flux = torch.cat([_spaced(gen, nstars, np.log(lo), np.log(hi)).exp(),
                      torch.full((nsat,), float(field["saturated_flux_e"]),
                                 device=gen.device)])
    return xs, ys, flux


@dataclasses.dataclass(frozen=True)
class Scene:
    """What every frame of a configuration shares."""
    geom: object                # the reference's CCDGeometry
    gains: tuple                # (C,) e-/ADU
    satlevel_adu: tuple         # (C,) raw ADU
    fwhm: float                 # px
    sky_e: float                # e- a pixel
    trail_e: float              # e- at the trail's centre line


def scene(config: dict) -> Scene:
    """A configuration file's scene, on the reference's geometry."""
    a = config["assumed"]
    return Scene(getattr(geometry, config["geometry"]),
                 tuple(config["gains"]), tuple(config["satlevel_adu"]),
                 a["fwhm_pix"], a["sky_e"], a["trail_e"])


def raw_frame(gen, scene: Scene, stars, ncosmics: int, trail: bool):
    """Raw (chan, os_vert, os_hori) float32 stacks of one frame on
    ``gen``'s device: ``stars`` (x, y, flux) deposited bilinearly and
    convolved with the Moffat PSF, then sky, noise, cosmics, the trail,
    the gains, saturation and bias."""
    dev = gen.device
    geom = scene.geom
    C = geom.n_chan
    H, W = geom.red_shape
    gain = torch.tensor(np.resize(np.asarray(scene.gains, np.float32), C),
                        device=dev)
    satlevel = torch.tensor(np.resize(np.asarray(scene.satlevel_adu,
                                                 np.float32), C), device=dev)

    xs, ys, flux = stars
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    ix, iy = x0.long(), y0.long()
    delta = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            delta.index_put_((torch.clamp(iy + dy, 0, H - 1),
                              torch.clamp(ix + dx, 0, W - 1)),
                             flux * wy * wx, accumulate=True)
    psf = moffat_kernel((H, W), scene.fwhm, device=dev)
    data_e = torch.fft.irfft2(torch.fft.rfft2(delta) * torch.fft.rfft2(psf),
                              s=(H, W))
    del delta, psf
    data_e = torch.clamp(data_e, min=0.0) + scene.sky_e

    # vignetting and a 1 % pixel response
    yv = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2) / (H / 2)
    xv = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2) / (W / 2)
    data_e *= 1.0 - 0.06 * (yv[:, None] ** 2 + xv[None, :] ** 2)
    data_e *= 1.0 + 0.01 * torch.randn((H, W), generator=gen, device=dev)
    # Poisson noise by the normal approximation
    data_e += torch.sqrt(torch.clamp(data_e, min=0.0)) * torch.randn(
        (H, W), generator=gen, device=dev)

    # cosmic rays: 1-px hits, with a 0.6x neighbour for 2 in 3
    cy = torch.randint(4, H - 4, (ncosmics,), generator=gen, device=dev)
    cx = torch.randint(4, W - 4, (ncosmics,), generator=gen, device=dev)
    camp = _spaced(gen, ncosmics, 3000.0, 40000.0)
    data_e.index_put_((cy, cx), camp, accumulate=True)
    second = torch.arange(ncosmics, device=dev) % 3 != 0
    data_e.index_put_((cy, cx + 1), torch.where(second, 0.6 * camp, 0.0),
                      accumulate=True)

    if trail:       # a gaussian-profile diagonal line across the frame
        yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        xa, ya, xb, yb = 0.1 * W, 0.2 * H, 0.9 * W, 0.8 * H
        nx_, ny_ = yb - ya, -(xb - xa)
        nrm = float(np.hypot(nx_, ny_))
        d = torch.abs((xx - xa) * (nx_ / nrm) + (yy - ya) * (ny_ / nrm))
        sig = max(scene.fwhm / 2.355, 0.8)
        data_e += scene.trail_e * torch.exp(-0.5 * (d / sig) ** 2)
        del d

    chan_adu = geom.disassemble(data_e) / gain[:, None, None]
    del data_e
    chan_adu = torch.minimum(chan_adu, satlevel[:, None, None] * 1.05)
    bias_level = _spaced(gen, C, 7000.0, 8000.0)
    rdnoise_adu = _spaced(gen, C, 4.0, 6.0)

    def with_bias(shape3):
        return (bias_level[:, None, None] + rdnoise_adu[:, None, None]
                * torch.randn(shape3, generator=gen, device=dev))

    chan = chan_adu + with_bias(chan_adu.shape)
    os_vert = with_bias((C, geom.dy, geom.os_vert_width))
    os_hori = with_bias((C, geom.os_hori_height, geom.dx))
    return chan, os_vert, os_hori


def masters(gen, geom, assumed: dict):
    """A master bias and flat of the channel stacks' shape on ``gen``'s
    device, and a (C, C) crosstalk matrix on the host, of a
    configuration's ``assumed`` spreads."""
    C, ych, xch = geom.chan_shape
    dev = gen.device
    mbias = assumed["mbias_rms_e"] * torch.randn((C, ych, xch),
                                                 generator=gen, device=dev)
    mflat = 1.0 + assumed["mflat_rms"] * torch.randn(
        (C, ych, xch), generator=gen, device=dev)
    u = torch.rand((C, C), generator=gen, device=dev, dtype=torch.float64)
    xtalk = ((2.0 * u - 1.0) * assumed["xtalk_max"]).cpu().numpy().astype(
        np.float32)
    return mbias, mflat, xtalk


def registration(shape, rot_deg: float, offset, step: int):
    """The coarse grid (sy, sx) that maps a visit's pixels onto the
    reference frame (a rotation about the centre and an offset, in the
    form the remap takes), and the map of a reference position into the
    visit's frame."""
    H, W = shape
    th = np.deg2rad(rot_deg)
    ct, st = np.cos(th), np.sin(th)
    cy, cx = 0.5 * H, 0.5 * W
    offx, offy = offset
    gy = np.arange(0, H + step, step, np.float64)
    gx = np.arange(0, W + step, step, np.float64)
    gyy, gxx = np.meshgrid(gy - cy, gx - cx, indexing="ij")
    sx = (cx + ct * gxx + st * gyy + offx).astype(np.float32)
    sy = (cy - st * gxx + ct * gyy + offy).astype(np.float32)

    def to_visit(x, y):
        """Reference (x, y) tensors -> the visit's pixel coordinates."""
        rx = x.double() - cx - offx
        ry = y.double() - cy - offy
        return ((cx + ct * rx - st * ry).float(),
                (cy + st * rx + ct * ry).float())

    return sy, sx, to_visit
