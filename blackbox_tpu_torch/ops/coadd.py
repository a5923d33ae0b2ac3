"""Co-addition: weighted and clipped stacking, mask voting (port of
:mod:`blackbox_tpu.ops.coadd`).

With the whole remapped stack on the device, the Gruen et al. 2014
clipping is a single pass: residuals against a first-guess median
co-add are compared to nsigma·σ_i + A·|model|, outliers get zero
weight, and the final image is the weighted mean of the survivors.
Star cores near saturated pixels are protected from clipping
(:func:`saturation_protect`).

Every function runs on its tensors' device, in plain PyTorch: the JAX
package combines in plain XLA, with no Pallas kernel.  The first-guess
median is ``jnp.nanmedian``'s along the stack axis (the two middle
values averaged where an even number of inputs is present), which
``torch.nanmedian`` is not: it returns the lower one.
:func:`a_swarp_search` is the JAX package's numpy code, copied
(``tests/test_torch_import.py`` holds it equal).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from blackbox_tpu_torch.core import maskbits


@dataclasses.dataclass(frozen=True)
class ClipParams:
    A: float = 0.3            # PSF-inaccuracy amplitude (A_swarp)
    nsigma: float = 2.5       # clip threshold in effective sigma
    nmin_clip: int = 3        # below this many images: no clipping
    # clipping disabled within this many FWHM of every saturated star
    protect_radius_fwhm: float = 5.0


def weighted_coadd(stack, weights):
    """Plain inverse-variance weighted mean.

    stack   : (N, H, W) background-subtracted, flux-scaled images
    weights : (N, H, W) inverse-variance weights (0 = excluded)
    Returns (coadd (H, W), wsum (H, W)).
    """
    wsum = torch.sum(weights, dim=0)
    co = torch.sum(stack * weights, dim=0) / torch.clamp(wsum, min=1e-12)
    return co, wsum


def saturation_protect(mask_stack, radius_pix: int):
    """Pixels within ``radius_pix`` (a square box) of any input's
    saturated footprint: a separable box maximum of the union saturation
    mask in which only in-frame pixels count.  Radius 0 returns the
    union itself."""
    sat = torch.any((mask_stack & (maskbits.SATURATED
                                   | maskbits.SAT_CONNECTED)) != 0, dim=0)
    r = int(radius_pix)
    if r <= 0:
        return sat
    # max_pool2d pads with -inf: out-of-frame pixels never win
    x = sat.to(torch.float32)[None, None]
    x = F.max_pool2d(x, (2 * r + 1, 1), stride=1, padding=(r, 0))
    x = F.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))
    return x[0, 0] > 0.5


def nanmedian_stack(big):
    """``jnp.nanmedian(big, axis=0)``: NaN sorts last, so the n present
    values of a pixel are its first n; the result weights ranks
    floor((n-1)/2) and ceil((n-1)/2) as the JAX package's quantile does
    (0.5 each for an even n).  NaN where no value is present."""
    s = torch.sort(big, dim=0).values
    n = torch.sum(~torch.isnan(big), dim=0).to(torch.float32)
    q = 0.5 * (n - 1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo = s.gather(0, torch.clamp(low, min=0).to(torch.int64)[None])[0]
    hi = s.gather(0, torch.clamp(high, min=0).to(torch.int64)[None])[0]
    return lo * lw + hi * hw


def clipped_coadd(stack, weights, sigmas, params: ClipParams = ClipParams(),
                  protect=None):
    """Gruen et al. 2014 outlier-clipped weighted co-add, one pass.

    stack   : (N, H, W) remapped, flux-scaled, background-subtracted
    weights : (N, H, W) inverse-variance weights (0 = off-frame/masked)
    sigmas  : (N,) per-image background STD in the common flux scale
    protect : optional (H, W) bool; clipping disabled there
    Returns (coadd, wsum, nclipped (H, W) int32).
    """
    p = params
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32,
                             device=stack.device)
    present = weights > 0
    npres = torch.sum(present, dim=0)

    # first-guess model: masked median over the stack
    big = torch.where(present, stack, torch.nan)
    model = torch.nan_to_num(nanmedian_stack(big))
    del big

    # clip where |x_i - model| > nsigma·σ_i + A·|model|
    sig = sigmas[:, None, None]
    resid = torch.abs(stack - model[None])
    thresh = p.nsigma * sig + p.A * torch.abs(model)[None]
    clipped = present & (resid > thresh)
    del resid, thresh

    if protect is not None:
        clipped = clipped & ~protect[None]

    # no clipping when fewer than nmin_clip images contribute
    clipped = clipped & (npres >= p.nmin_clip)[None]

    w = torch.where(clipped, 0.0, weights)
    # never clip all images of a pixel
    all_gone = torch.sum(w, dim=0) <= 0
    w = torch.where(all_gone[None], weights, w)

    co, wsum = weighted_coadd(stack, w)
    return co, wsum, torch.sum(clipped, dim=0).to(torch.int32)


def coadd_mask(mask_stack, or_bits: int | None = None,
               vote_frac: float = 0.5):
    """Combine nearest-remapped uint8 masks.

    * EDGE is set only where no image contributes (off-frame everywhere).
    * Other bits are set where at least ``vote_frac`` of the contributing
      images carry the bit, except ``or_bits``, which are OR'd
      unconditionally.
    """
    if or_bits is None:
        or_bits = maskbits.SATURATED | maskbits.SAT_CONNECTED
    contributes = (mask_stack & maskbits.EDGE) == 0
    ncon = torch.sum(contributes, dim=0)

    out = torch.where(ncon == 0, maskbits.EDGE, 0).to(torch.uint8)
    need = torch.clamp(vote_frac * ncon, min=1)
    for bit in maskbits.BITS.values():
        if bit == maskbits.EDGE:
            continue
        has = ((mask_stack & bit) != 0) & contributes
        nbit = torch.sum(has, dim=0)
        setb = nbit > 0 if bit & or_bits else nbit >= need
        out = torch.where(setb & (ncon > 0), out | bit, out)
    return out


def coadd_bkg_std(wsum):
    """Per-pixel background STD of the co-add from the weight sum."""
    return 1.0 / torch.sqrt(torch.clamp(wsum, min=1e-12))


def effective_headers(gains, rdnoises, saturates, fscales, weights_used):
    """Effective GAIN/RDNOISE/SATURATE of a weighted co-add: the
    flux-scale-aware combination with normalised weights (N,)."""
    f32 = dict(dtype=torch.float32)
    gains, rdnoises, saturates, fscales, weights_used = (
        torch.as_tensor(v, **f32)
        for v in (gains, rdnoises, saturates, fscales, weights_used))
    w = weights_used / torch.clamp(torch.sum(weights_used), min=1e-12)
    gain_eff = torch.sum(w * gains * fscales)
    rdnoise_eff = torch.sqrt(torch.sum((w * rdnoises * fscales) ** 2))
    saturate_eff = torch.min(saturates * fscales)
    return gain_eff, rdnoise_eff, saturate_eff


def a_swarp_search(psf_stamps, valid,
                   A_range=(0.3, 5.1, 0.1), nsigma_range=(2.5, 3.6, 0.5),
                   nlimit_frac: float = 0.01, keep_frac: float = 2 / 3):
    """Gruen PSFHomTest: pick the smallest (A, nsigma) whose expected
    clipped-pixel count over the PSF stamps is acceptable.

    Each input's centre PSF is compared with the median PSF, counting
    pixels where |psf_i - med| > nsigma·σ + A·med over an (A, nsigma)
    grid; σ is the empirical pixel scatter over the stamps.

    psf_stamps : (N, S, S) unit-sum PSF stamps of the input images
    valid      : (N,) which stamps participate
    Returns (A, nsigma, n_outliers, n_images_kept).
    """
    import numpy as np

    psf = np.asarray(psf_stamps, np.float64)
    ok = np.asarray(valid, bool)
    psf = psf[ok]
    N = len(psf)
    if N < 3:
        a0 = float(np.arange(*A_range)[-1])
        return a0, float(nsigma_range[0]), 0, N
    med = np.median(psf, axis=0)
    sig = 1.4826 * np.median(np.abs(psf - med), axis=0) + 1e-12
    npix = med.size
    nlimit = max(int(nlimit_frac * npix), 1)

    for A in np.arange(*A_range):
        for ns in np.arange(*nsigma_range):
            out = np.abs(psf - med) > ns * sig + A * np.abs(med)
            per_img = out.reshape(N, -1).sum(axis=1)
            kept = per_img <= nlimit
            if kept.sum() >= keep_frac * N:
                return float(A), float(ns), int(per_img[kept].sum()), \
                    int(kept.sum())
    return float(np.arange(*A_range)[-1]), float(nsigma_range[0]), 0, N
