"""L.A.Cosmic cosmic-ray rejection (port of the dense clean-once
iteration of :mod:`blackbox_tpu.ops.cosmics`).

Laplacian edge detection on the 2x-subsampled image, normalised by a
Poisson+readnoise model, compared against the fine structure of the
image to separate sharp cosmic rays from stars, grown to neighbours,
and cleaned with a masked 5x5 median (van Dokkum 2001, PASP 113, 1420).
The four k x k medians of each detection round run on the card through
the CUDA kernel ``csrc/medians.cu``.

Clean-once semantics, as in the JAX package: each cosmic pixel is
replaced exactly once, in the round that detects it, so a round after
one with zero new detections is a no-op and is skipped (the count is
read on the host).  The JAX package's windowed and pre-screened rounds
are exact cost devices for the TPU (held bit-identical to this dense
round by its own tests): their switches are accepted and ignored.
"""

from __future__ import annotations

import dataclasses

import torch

from blackbox_tpu_torch.ops.filters import (dilate, laplacian_subsampled,
                                            masked_median_filter,
                                            median_filter)


@dataclasses.dataclass(frozen=True)
class LACosmicParams:
    sigclip: float = 15.0
    sigfrac: float = 0.01
    objlim: float = 3.0
    niter: int = 3
    strip_rows: int = 176       # row strip of the plain median networks
    # switches of the JAX package's variants.  clean_cap > 0 (sparse
    # clean), sepmed (separable medians) and use_pallas (the fused TPU
    # iteration) change results and are not ported; the rest select
    # exact TPU cost devices and do not change results.
    clean_cap: int = 0
    sepmed: bool = False
    use_pallas: bool = False
    pallas_medians: bool | None = None
    prescreen: bool = False
    windowed: bool = True
    cell: int = 64
    max_cells: int = 4096
    window_chunk: int = 256


def lacosmic(data, inmask, rdnoise, params: LACosmicParams = LACosmicParams()):
    """Detect and clean cosmic rays.

    data    : (H, W) float32, e- (sky-included, calibrated)
    inmask  : (H, W) bool — pixels excluded from detection, or None
    rdnoise : scalar or (H, W) read noise [e-]

    Returns (cleaned data, crmask bool, per-round new-detection counts).
    """
    p = params
    if p.clean_cap > 0 or p.sepmed or p.use_pallas:
        raise NotImplementedError(
            "lacosmic: clean_cap > 0, sepmed and use_pallas are not "
            "ported; the port runs the dense clean-once round")
    if inmask is None:
        inmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    counts = []
    for _ in range(p.niter):
        if counts and int(counts[-1]) == 0:
            # a round after a zero-new round is a no-op (clean-once)
            counts.append(counts[-1])
            continue
        cosm, m5un = _detect_math(clean, ~inmask, rdnoise, p)
        new = cosm & ~crmask
        crmask = crmask | cosm
        repl = masked_median_filter(clean, crmask | inmask, 5, p.strip_rows,
                                    fallback=m5un)
        clean = torch.where(new, repl, clean)
        counts.append(torch.sum(new, dtype=torch.int32))
    return clean, crmask, torch.stack(counts)


def _detect_math(clean, good, rdnoise, p: LACosmicParams):
    """One L.A.Cosmic detection round.

    Returns (cosm bool, unclamped 5x5 median of ``clean``).
    """
    m5un = median_filter(clean, 5, p.strip_rows)
    # noise model from the 5x5 median (gain = 1: data already in e-)
    m5 = torch.clamp(m5un, min=1e-5)
    noise = torch.sqrt(m5 + rdnoise ** 2)

    # Laplacian SNR, large-scale structure removed
    s = laplacian_subsampled(clean) / (2.0 * noise)
    sp = s - median_filter(s, 5, p.strip_rows)

    # fine structure: med3 - med7(med3), floor 0.01
    m3 = median_filter(clean, 3, p.strip_rows)
    m37 = median_filter(m3, 7, p.strip_rows)
    f = torch.clamp((m3 - m37) / noise, min=0.01)

    cosm = (sp > p.sigclip) & (sp / f > p.objlim) & good
    # grow to neighbours that are also significant
    cosm = dilate(cosm, 3) & (sp > p.sigclip) & good
    # wider growth at the reduced threshold
    cosm = dilate(cosm, 5) & (sp > p.sigclip * p.sigfrac) & good
    return cosm, m5un
