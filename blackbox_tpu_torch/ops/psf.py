"""Spatially-varying PSF model and optimal PSF photometry (port of
:mod:`blackbox_tpu.ops.psf`).

The PSF is one dense weighted least-squares over all star vignettes at
once, ``V[i, p] ≈ Σ_k B[i, k]·C[k, p]`` with ``V`` the flux-normalised
vignettes and ``B`` the polynomial spatial basis at the star positions:
two matmuls and one (nbasis, nbasis) solve, repeated for a fixed number
of chi² reweighting rounds.  :class:`PSFModel` keeps the PSFEx header
contract (``poldeg``, ``polzero_*``, ``polscal_*``).  The vignette
windows come from :func:`gather_slot_windows` (the CUDA gather kernel
on the card); the per-slot maths is one batch over the slot axis, and
slots at or past ``n_active`` see zero windows (the JAX package skips
whole chunks of them), so the two agree on live slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackbox_tpu_torch.ops.stats import masked_median
from blackbox_tpu_torch.ops.windows import gather_slot_windows
from blackbox_tpu_torch.utils.timing import count


@dataclasses.dataclass(frozen=True)
class PSFParams:
    size: int = 25            # vignette / PSF stamp size (odd)
    poldeg: int = 2           # spatial polynomial degree
    snr_min: float = 20.0     # star selection
    elong_max: float = 1.5
    niter: int = 3            # reweighting iterations
    chi2_clip: float = 10.0   # reject stars with chi2/dof above this
    sat_frac: float = 0.8     # peak above sat_frac*satlevel rejected


@dataclasses.dataclass
class PSFModel:
    """PSFEx-compatible spatially-varying PSF.

    basis : (nbasis, size, size) polynomial coefficient images C[k]
    polzero_x/y, polscal_x/y : position normalisation,
        t = (x - polzero_x) / polscal_x   (0-d float32 tensors)
    poldeg : spatial degree; nbasis = (poldeg+1)(poldeg+2)/2
    nstars : stars used in the fit (0-d int32);  chi2 : final chi2
    """

    basis: torch.Tensor
    polzero_x: torch.Tensor
    polzero_y: torch.Tensor
    polscal_x: torch.Tensor
    polscal_y: torch.Tensor
    poldeg: int
    nstars: torch.Tensor
    chi2: torch.Tensor

    @classmethod
    def from_reference(cls, model, device="cpu"):
        """Carry a JAX ``PSFModel`` across through numpy arrays."""
        def arr(v):
            return torch.from_numpy(np.array(v)).to(device)

        return cls(basis=arr(model.basis), polzero_x=arr(model.polzero_x),
                   polzero_y=arr(model.polzero_y),
                   polscal_x=arr(model.polscal_x),
                   polscal_y=arr(model.polscal_y),
                   poldeg=int(model.poldeg), nstars=arr(model.nstars),
                   chi2=arr(model.chi2))


def poly_basis(tx, ty, poldeg: int):
    """PSFEx ordering of the 2-D monomials x^i y^j, i + j <= poldeg
    (j outer, i inner).  Returns (..., nbasis)."""
    terms = []
    for j in range(poldeg + 1):
        for i in range(poldeg + 1 - j):
            terms.append((tx ** i) * (ty ** j))
    return torch.stack(terms, dim=-1)


def n_basis(poldeg: int) -> int:
    return (poldeg + 1) * (poldeg + 2) // 2


def _vignette_grid(image_shape, xs, ys, size: int):
    """FLOOR stamp origins + window-local shifts for centred cutouts
    (see the JAX package: the integer part of the shift, non-zero where
    the origin clip binds at the frame border, is absorbed by
    :func:`_recenter_window` with edge replication)."""
    H, W = image_shape
    half = size // 2
    fy = ys - half
    fx = xs - half
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, H - size - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, W - size - 1)
    dy = fy - y0.to(torch.float32)
    dx = fx - x0.to(torch.float32)
    return y0, x0, dx, dy


def _recenter_window(w, dxi, dyi):
    """Recentred (N, S, S) stamps from (N, S+1, S+1) floor-origin
    windows: ``My @ w @ Mx.T`` with the two-tap selection-lerp matrices
    built from each window's scalar shifts (edge replication where the
    shift leaves the window)."""
    S1 = w.shape[-1]
    S = S1 - 1
    g = torch.arange(S, dtype=torch.float32, device=w.device)[:, None]
    k = torch.arange(S1, dtype=torch.float32, device=w.device)[None, :]

    def sel(d):
        d = d[:, None, None]
        s = torch.floor(d)
        t = d - s
        c0 = torch.clamp(g + s, 0, S)
        c1 = torch.clamp(g + s + 1, 0, S)
        return (1.0 - t) * (k == c0) + t * (k == c1)     # (N, S, S+1)

    out = torch.matmul(sel(dyi), w)
    return torch.matmul(out, sel(dxi).transpose(1, 2))


def extract_vignettes(image, xs, ys, size: int, n_active=None):
    """Centred cutouts, recentred so the star centroid lands on the
    central pixel (bilinear).  Returns (vignettes (N, size, size), dx,
    dy)."""
    y0, x0, dx, dy = _vignette_grid(image.shape, xs, ys, size)
    w = gather_slot_windows(image, y0, x0, size + 1, n_active=n_active)
    return _recenter_window(w, dx, dy), dx, dy


def build_psf(image_bksub, bkg_std, cat, image_shape,
              params: PSFParams = PSFParams(), n_active=None):
    """Fit the spatially-varying PSF from a fixed-capacity catalog.

    cat must hold x, y, snr, elong, valid — all (N,).  Returns a
    :class:`PSFModel`.
    """
    p = params
    H, W = image_shape
    dev = image_bksub.device
    xs, ys = cat["x"], cat["y"]
    star = (cat["valid"]
            & (cat["snr"] > p.snr_min)
            & (cat["elong"] < p.elong_max)
            & (xs > p.size) & (xs < W - p.size)
            & (ys > p.size) & (ys < H - p.size))

    S = p.size
    y0, x0, dx, dy = _vignette_grid(image_shape, xs, ys, S)
    v_all, sd_all = gather_slot_windows((image_bksub, bkg_std), y0, x0,
                                        S + 1, n_active=n_active)
    vig = _recenter_window(v_all, dx, dy)
    # bkg + Poisson variance [e-] of the unshifted window corner
    var = (sd_all[:, :-1, :-1] ** 2
           + torch.clamp(v_all[:, :-1, :-1], min=0.0))

    flux = torch.sum(vig, dim=(1, 2))
    star = star & (flux > 0)
    fsafe = torch.where(flux > 0, flux, 1.0)
    Vn = vig / fsafe[:, None, None]                  # flux-normalised
    Wn = fsafe[:, None, None] ** 2 / torch.clamp(var, min=1e-9)

    # spatial basis at star positions, PSFEx normalisation
    zx, zy = 0.5 * (W - 1), 0.5 * (H - 1)
    sx, sy = 0.5 * W, 0.5 * H
    B = poly_basis((xs - zx) / sx, (ys - zy) / sy, p.poldeg)  # (N, K)

    npix = p.size * p.size
    V = Vn.reshape(-1, npix)
    Wflat = Wn.reshape(-1, npix)
    K = B.shape[-1]
    order = torch.tensor([i + j for j in range(p.poldeg + 1)
                          for i in range(p.poldeg + 1 - j)],
                         dtype=torch.float32, device=dev)

    def solve(w_star):
        """Weighted LSQ with per-star scalar weights; returns
        (C (K, npix), chi2 per star)."""
        wBT = B.T * w_star[None, :]
        A = torch.matmul(wBT, B)                                # (K, K)
        # few stars cannot constrain the spatial terms: ridge the
        # under-determined orders toward zero (a near-constant PSF), as
        # PSFEx lowers PSFVAR_DEGREES
        nst = torch.sum(w_star > 0.0)
        under = torch.clamp(3.0 * K - nst, min=0.0) / (3.0 * K)
        lam = 1e-6 + 10.0 * under * (order > 0)
        A = A + torch.diag(lam) * (torch.trace(A) / K + 1e-20)
        rhs = torch.matmul(wBT, V)                              # (K, npix)
        C = torch.linalg.solve(A, rhs)
        count("host.reads")         # the solve reads its error flags
        resid = V - torch.matmul(B, C)
        chi2 = torch.sum(resid ** 2 * Wflat, dim=1) / npix
        return C, chi2

    # uniform per-star weights: vignettes are flux-normalised, so every
    # selected star constrains the unit-flux PSF equally
    w0 = torch.where(star, 1.0, 0.0)
    w = w0
    for _ in range(p.niter - 1):
        _, chi2 = solve(w)
        med = masked_median(chi2, w <= 0, axis=0)
        keep = chi2 < p.chi2_clip * torch.clamp(med, min=1e-6)
        w = torch.where(star & keep, w0, 0.0)
    C, chi2 = solve(w)

    used = w > 0

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return PSFModel(
        basis=C.reshape(K, p.size, p.size),
        polzero_x=f32(zx), polzero_y=f32(zy),
        polscal_x=f32(sx), polscal_y=f32(sy),
        poldeg=p.poldeg,
        nstars=torch.sum(used, dtype=torch.int32),
        chi2=masked_median(chi2, ~used, axis=0))


def psf_at(model: PSFModel, x, y, clip: bool = True):
    """Sample the PSF image at position(s); normalised to unit sum.

    x, y scalar -> (S, S); (N,) -> (N, S, S).
    """
    dev = model.basis.device
    tx = (torch.as_tensor(x, dtype=torch.float32, device=dev)
          - model.polzero_x) / model.polscal_x
    ty = (torch.as_tensor(y, dtype=torch.float32, device=dev)
          - model.polzero_y) / model.polscal_y
    B = poly_basis(tx, ty, model.poldeg)             # (..., K)
    psf = torch.tensordot(B, model.basis, dims=([-1], [0]))
    if clip:
        psf = torch.clamp(psf, min=0.0)
    s = torch.sum(psf, dim=(-2, -1), keepdim=True)
    return psf / torch.clamp(s, min=1e-9)


def psf_fwhm(psf_img):
    """FWHM from the second moments of a PSF stamp (Gaussian equiv)."""
    S = psf_img.shape[-1]
    g = torch.arange(S, dtype=torch.float32, device=psf_img.device)
    w = torch.clamp(psf_img, min=0.0)
    tot = torch.sum(w, dim=(-2, -1))
    xc = torch.sum(w * g[None, :], dim=(-2, -1)) / tot
    yc = torch.sum(w * g[:, None], dim=(-2, -1)) / tot
    x2 = torch.sum(w * (g[None, :] - xc[..., None, None]) ** 2,
                   dim=(-2, -1)) / tot
    y2 = torch.sum(w * (g[:, None] - yc[..., None, None]) ** 2,
                   dim=(-2, -1)) / tot
    log2 = torch.log(torch.tensor(2.0, dtype=torch.float32,
                                  device=psf_img.device))
    return 2.0 * torch.sqrt(log2 * torch.clamp(x2 + y2, min=1e-9))


def psf_photometry(image_bksub, bkg_std, model: PSFModel, xs, ys,
                   window: int | None = None, n_active=None):
    """Optimal (matched-filter) PSF flux at given positions.

    F = Σ P·D/σ² / Σ P²/σ²,  σ_F = (Σ P²/σ²)^(-1/2) (Naylor 1998).
    Returns (flux, fluxerr) of shape (N,).
    """
    S = model.basis.shape[-1] if window is None else window
    y0, x0, dx, dy = _vignette_grid(image_bksub.shape, xs, ys, S)
    v_all, sd_all = gather_slot_windows((image_bksub, bkg_std), y0, x0,
                                        S + 1, n_active=n_active)
    # recentre the DATA with the bilinear shift the model's vignettes
    # had, so both carry the same interpolation smoothing
    v = _recenter_window(v_all, dx, dy)
    sd = _recenter_window(sd_all, dx, dy)
    P = psf_at(model, xs, ys)                        # (N, S, S)
    # background-only variance in the weights: the source's own Poisson
    # noise would correlate weights with data and bias bright stars low
    var = sd ** 2
    ivar = 1.0 / torch.clamp(var, min=1e-9)
    den = torch.sum(P * P * ivar, dim=(1, 2))
    num = torch.sum(P * v * ivar, dim=(1, 2))
    flux = num / torch.clamp(den, min=1e-12)
    # the reported error still includes the source Poisson term
    err2 = torch.sum(P * P * ivar * ivar * (var + torch.clamp(v, min=0.0)),
                     dim=(1, 2)) / torch.clamp(den, min=1e-12) ** 2
    return flux, torch.sqrt(torch.clamp(err2, min=1e-12))
