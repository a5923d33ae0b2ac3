"""L.A.Cosmic cosmic-ray rejection (port of
:mod:`blackbox_tpu.ops.cosmics`).

Laplacian edge detection on the 2x-subsampled image, normalised by a
Poisson+readnoise model, compared against the fine structure of the
image to separate sharp cosmic rays from stars, grown to neighbours,
and cleaned with a masked 5x5 median (van Dokkum 2001, PASP 113, 1420).

The variants follow the JAX package's ``LACosmicParams``, in its order:

- ``use_pallas``: the fused iteration of the TPU kernel K7, ported as
  :func:`blackbox_tpu_torch.ops.lacosmic_fused.lacosmic_fused` (CUDA
  kernel ``csrc/lacosmic.cu``).  It computes a different function from
  the dense round (it re-cleans every flagged pixel each iteration).
- ``sepmed``: separable medians for detection, dense masked clean.
- the dense clean-once round otherwise, its four k x k medians on the
  card through the CUDA kernel ``csrc/medians.cu``; with
  ``clean_cap > 0`` and the unwindowed path (``windowed=False``, or a
  per-pixel read-noise map) the clean is the sparse one.

Clean-once semantics, as in the JAX package: each cosmic pixel is
replaced exactly once, in the round that detects it, so a round after
one with zero new detections is a no-op and is skipped (the count is
read on the host).  With ``coords`` the data is a column block of a
wider frame (:func:`blackbox_tpu_torch.parallel.mesh.lacosmic_sharded`):
the rounds run a fixed number of times, with the border masks in frame
coordinates.  The JAX package's windowed and pre-screened rounds
are exact cost devices for the TPU (held bit-identical to the dense
round by its own tests): their switches are accepted and select the
dense round, after the JAX package's argument checks.
"""

from __future__ import annotations

import dataclasses

import torch

from blackbox_tpu_torch.ops.filters import (dilate, laplacian_subsampled,
                                            masked_median_filter,
                                            median_filter, median_filter_sep)


@dataclasses.dataclass(frozen=True)
class LACosmicParams:
    sigclip: float = 15.0
    sigfrac: float = 0.01
    objlim: float = 3.0
    niter: int = 3
    strip_rows: int = 176       # row strip of the plain median networks
    clean_cap: int = 0          # > 0: sparse clean (unwindowed path only)
    sepmed: bool = False        # separable detection medians
    use_pallas: bool = False    # the fused iteration (K7)
    # exact TPU cost devices of the JAX package: accepted (prescreen
    # only raises the JAX package's argument checks), no other effect
    pallas_medians: bool | None = None
    prescreen: bool = False
    windowed: bool = True
    cell: int = 64
    max_cells: int = 4096
    window_chunk: int = 256


def lacosmic(data, inmask, rdnoise, params: LACosmicParams = LACosmicParams(),
             coords=None):
    """Detect and clean cosmic rays.

    data    : (H, W) float32, e- (sky-included, calibrated)
    inmask  : (H, W) bool — pixels excluded from detection, or None
    rdnoise : scalar or (H, W) read noise [e-]
    coords  : optional (col0, W_total) when ``data`` is a column block
              of a wider frame (the sharded path): the border masks
              then use frame coordinates, so a block's interior equals
              the whole frame's dense result there.

    Returns (cleaned data, crmask bool, per-round new-detection counts).
    """
    p = params
    if p.prescreen and (not p.windowed or p.sepmed):
        raise ValueError("LACosmicParams.prescreen requires the windowed "
                         "iteration machinery (windowed=True, "
                         "sepmed=False) — it places exact windowed "
                         "detection from the seed superset")
    if p.use_pallas:
        from blackbox_tpu_torch.ops.lacosmic_fused import lacosmic_fused
        return lacosmic_fused(data, inmask, rdnoise, sigclip=p.sigclip,
                              sigfrac=p.sigfrac, objlim=p.objlim,
                              niter=p.niter)
    if inmask is None:
        inmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    if coords is not None:
        return _lacosmic_dense_coords(data, inmask, rdnoise, p, coords)
    if p.sepmed:
        return _rounds(data, inmask, rdnoise, p,
                       lambda a, k: median_filter_sep(a, k, p.strip_rows))
    # the JAX package's windowed rounds need a scalar read noise; a map
    # takes its dense path, where the sparse clean applies
    windowed = p.windowed and torch.as_tensor(rdnoise).dim() == 0
    if p.prescreen and not windowed:
        raise ValueError("LACosmicParams.prescreen needs the windowed "
                         "path, which requires a SCALAR rdnoise — a "
                         "per-pixel read-noise map forces the dense "
                         "path and would silently skip the requested "
                         "pre-screen")
    cap = 0 if windowed else p.clean_cap
    return _rounds(data, inmask, rdnoise, p,
                   lambda a, k: median_filter(a, k, p.strip_rows), cap)


def _rounds(data, inmask, rdnoise, p: LACosmicParams, medf, clean_cap=0):
    """``p.niter`` clean-once rounds with detection medians ``medf``."""
    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    counts = []
    for _ in range(p.niter):
        if counts and int(counts[-1]) == 0:
            # a round after a zero-new round is a no-op (clean-once)
            counts.append(counts[-1])
            continue
        cosm, m5un = _detect_math(clean, ~inmask, rdnoise, p, medf)
        new = cosm & ~crmask
        crmask = crmask | cosm
        if clean_cap > 0:
            clean = _sparse_masked_clean(clean, new, crmask | inmask,
                                         torch.clamp(m5un, min=1e-5),
                                         clean_cap)
        else:
            repl = masked_median_filter(clean, crmask | inmask, 5,
                                        p.strip_rows, fallback=m5un)
            clean = torch.where(new, repl, clean)
        counts.append(torch.sum(new, dtype=torch.int32))
    return clean, crmask, torch.stack(counts)


def _lacosmic_dense_coords(data, inmask, rdnoise, p: LACosmicParams,
                           coords):
    """Dense rounds on a column block with the border masks in frame
    coordinates (the JAX package's ``_lacosmic_dense_coords``).

    The k x k medians (K2 on the card) and the masked clean keep the
    input only on the frame's border, so a shard seam gets the stencil
    results its halo columns feed.  The block's own outer columns (its
    halo) may differ from the JAX package's edge-padded medians; the
    caller discards them.  The rounds run ``p.niter`` times with no
    early exit, which needs the frame's count; a round after one with
    no new detection is a no-op (clean-once), so the result is the
    guarded dense path's.  The clean keeps a NaN median, as the JAX
    package's windowed clean does.
    """
    col0, W_total = coords
    H, W = data.shape
    dev = data.device
    ri = torch.arange(H, device=dev)[:, None]
    ci = (int(col0) + torch.arange(W, device=dev))[None, :]

    def bk(pk):
        return (ri < pk) | (ri >= H - pk) | (ci < pk) | (ci >= W_total - pk)

    ring = (ri == 0) | (ri == H - 1) | (ci == 0) | (ci == W_total - 1)
    border2 = bk(2)

    def medf(a, k):
        return torch.where(bk(k // 2), a, median_filter(a, k, p.strip_rows))

    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=dev)
    counts = []
    for _ in range(p.niter):
        cosm, m5un = _detect_math(clean, ~inmask, rdnoise, p, medf,
                                  lambda v: laplacian_subsampled(v, ring))
        new = cosm & ~crmask
        counts.append(torch.sum(new, dtype=torch.int32))
        crmask = crmask | cosm
        repl = masked_median_filter(clean, crmask | inmask, 5, p.strip_rows,
                                    fallback=m5un, nan_fallback=False)
        clean = torch.where(new & ~border2, repl, clean)
    return clean, crmask, torch.stack(counts)


def _detect_math(clean, good, rdnoise, p: LACosmicParams, medf,
                 lapf=laplacian_subsampled):
    """One L.A.Cosmic detection round with border-keeping k x k medians
    ``medf(a, k)`` and the ring-zeroed subsampled Laplacian ``lapf``.

    Returns (cosm bool, unclamped 5x5 median of ``clean``).
    """
    m5un = medf(clean, 5)
    # noise model from the 5x5 median (gain = 1: data already in e-)
    m5 = torch.clamp(m5un, min=1e-5)
    noise = torch.sqrt(m5 + rdnoise ** 2)

    # Laplacian SNR, large-scale structure removed
    s = lapf(clean) / (2.0 * noise)
    sp = s - medf(s, 5)

    # fine structure: med3 - med7(med3), floor 0.01
    m3 = medf(clean, 3)
    m37 = medf(m3, 7)
    f = torch.clamp((m3 - m37) / noise, min=0.01)

    cosm = (sp > p.sigclip) & (sp / f > p.objlim) & good
    # grow to neighbours that are also significant
    cosm = dilate(cosm, 3) & (sp > p.sigclip) & good
    # wider growth at the reduced threshold
    cosm = dilate(cosm, 5) & (sp > p.sigclip * p.sigfrac) & good
    return cosm, m5un


def _sparse_masked_clean(clean, crmask, bad, m5, cap: int):
    """Replace the first ``cap`` cosmic pixels (raster order) by the
    masked 5x5 median of their good neighbours, evaluated only there.

    Pixels within 2 px of the frame edge keep their value; an all-bad
    neighbourhood takes ``m5`` (the CLAMPED 5x5 median).  Plain PyTorch
    on every device (the JAX package has no kernel for it).
    """
    H, W = clean.shape
    pos = torch.nonzero(crmask.reshape(-1))[:cap, 0]
    py, px = pos // W, pos % W
    keep = (py >= 2) & (py < H - 2) & (px >= 2) & (px < W - 2)
    py, px = py[keep], px[keep]
    off = torch.arange(-2, 3, device=clean.device)
    wy = (py[:, None, None] + off[None, :, None]).expand(-1, 5, 5)
    wx = (px[:, None, None] + off[None, None, :]).expand(-1, 5, 5)
    b = bad[wy, wx].reshape(-1, 25)
    vals = torch.where(b, 3.0e38, clean[wy, wx].reshape(-1, 25))
    s = torch.sort(vals, dim=1).values
    n = torch.sum(~b, dim=1)
    lo = s.gather(1, (torch.clamp(n - 1, min=0) // 2)[:, None])[:, 0]
    hi = s.gather(1, (n // 2)[:, None])[:, 0]
    med = torch.where(n > 0, 0.5 * (lo + hi), m5[py, px])
    out = clean.clone()
    out[py, px] = med
    return out
