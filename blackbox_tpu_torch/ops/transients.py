"""Transient extraction and vetting on the ZOGY Scorr statistic (port of
:mod:`blackbox_tpu.ops.transients`).

Threshold |Scorr|, label, reduce per-segment moments and PSF fluxes over
windows around each segment's root, and apply the deterministic
vetting cuts; the catalog keeps ``max_transients`` slots.  The labels
come from :func:`label_segments` (the label-propagation kernel on the
card) or, under the JAX package's switch ``BBTPU_PALLAS_DETECT=1``,
from the fused detection kernel :func:`fused_detect`.
"""

from __future__ import annotations

import dataclasses

import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.ops.detection import (fused_detect, label_segments,
                                              pallas_detect_enabled,
                                              segment_roots)
from blackbox_tpu_torch.ops.windows import gather_slot_windows


@dataclasses.dataclass(frozen=True)
class TransientParams:
    nsigma: float = 6.0           # set_zogy transient_nsigma equivalent
    max_transients: int = 2000
    label_iters: int = 48
    npix_min: int = 2
    elong_max: float = 3.0        # vetting: trail-like shapes rejected
    npix_max: int = 500           # vetting: giant segments rejected
    mask_reject: int = (maskbits.BAD | maskbits.SATURATED
                        | maskbits.SAT_CONNECTED | maskbits.EDGE
                        | maskbits.SATELLITE)
    dipole_frac: float = 0.5      # |neg|/|pos| overlap above this -> dipole
    moment_window: int = 48       # per-segment moment window [pix]

    @classmethod
    def from_reference(cls, ref):
        """The same parameters from a JAX ``TransientParams``, read by
        field name."""
        return cls(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(cls)})


def extract_transients(zogy_out, mask_new=None, mask_ref=None,
                       params: TransientParams = TransientParams()):
    """Fixed-capacity transient catalog from the Scorr map.

    zogy_out : dict from :func:`blackbox_tpu_torch.ops.zogy.zogy_subtract`
    mask_new/mask_ref : optional uint8 mask mosaics on the same grid
    Returns (cat dict of (max_transients,) tensors, n_transients).
    """
    p = params
    Scorr = zogy_out["Scorr"]
    Fpsf = zogy_out["Fpsf"]
    Fpsferr = zogy_out["Fpsferr"]
    D = zogy_out["D"]
    H, W = Scorr.shape
    dev = Scorr.device

    bad = torch.zeros((H, W), dtype=torch.bool, device=dev)
    if mask_new is not None:
        bad |= (mask_new & p.mask_reject) != 0
    if mask_ref is not None:
        bad |= (mask_ref & p.mask_reject) != 0

    # the JAX package's rule for the fused kernel, "on a TPU" read as
    # "on a CUDA device"
    if (dev.type == "cuda" and p.label_iters <= 64 and H >= 512
            and W >= 512 and pallas_detect_enabled()):
        seg, n = fused_detect(Scorr, None, bad, None, p.nsigma,
                              iters=p.label_iters, absval=True)
    else:
        det = (torch.abs(Scorr) > p.nsigma) & ~bad
        seg, n = label_segments(det, p.label_iters)

    # windowed per-segment moments around each segment's root
    win = min(p.moment_window, H, W)
    root = segment_roots(seg, p.max_transients)
    rootval = seg.reshape(-1)[root]
    y0 = torch.clamp(torch.div(root, W, rounding_mode="floor") - win // 3,
                     0, H - win)
    x0 = torch.clamp(root % W - win // 2, 0, W - win)
    g = torch.arange(win, dtype=torch.float32, device=dev)
    sw, sv = gather_slot_windows((seg, Scorr), y0, x0, win, n_active=n)

    k = rootval[:, None, None]
    m = (sw == k) & (k > 0)
    mf = m.to(torch.float32)
    av = torch.abs(sv)
    a = av * mf
    # window-local coordinates for the moment sums (absolute-coordinate
    # squares lose the few-px² central moments to f32 cancellation)
    yy = g[None, :, None]
    xx = g[None, None, :]

    def wsum_of(x):
        return torch.sum(x, dim=(1, 2))

    npix = wsum_of(mf)
    wsum = wsum_of(a)
    off_x = x0.to(torch.float32)
    off_y = y0.to(torch.float32)
    wsafe1 = torch.clamp(wsum, min=1e-9)
    xl = wsum_of(a * xx) / wsafe1
    yl = wsum_of(a * yy) / wsafe1
    wx = (xl + off_x) * wsum
    wy = (yl + off_y) * wsum
    dxl = xx - xl[:, None, None]
    dyl = yy - yl[:, None, None]
    x2c = wsum_of(a * dxl ** 2) / wsafe1
    y2c = wsum_of(a * dyl ** 2) / wsafe1
    xyc = wsum_of(a * dxl * dyl) / wsafe1
    peak_abs = torch.amax(torch.where(m, av, 0.0), dim=(1, 2))
    pos_sum = wsum_of(torch.clamp(sv, min=0.0) * mf)
    neg_sum = wsum_of(torch.clamp(-sv, min=0.0) * mf)
    # position = the segment's |Scorr| PEAK pixel; flat indices stay in
    # int32 (f32 cannot hold indices past 2^24 and would shift peaks by
    # up to +-4 px on a full frame)
    att = m & (av >= peak_abs[:, None, None] - 1e-6)
    gi = torch.arange(win, dtype=torch.int32, device=dev)
    flat = ((gi[None, :, None] + y0[:, None, None]) * W
            + (gi[None, None, :] + x0[:, None, None]))
    peak_idx = torch.amin(torch.where(att & (npix[:, None, None] > 0),
                                      flat, H * W), dim=(1, 2))
    # segment pixels on the window border: the segment spills past the
    # window, so the giant-segment vet treats it as over-sized
    truncated = (m[:, 0, :].any(1) | m[:, -1, :].any(1)
                 | m[:, :, 0].any(1) | m[:, :, -1].any(1))

    has_peak = peak_idx < H * W
    peak_idx = torch.clamp(peak_idx, 0, H * W - 1)
    xp = (peak_idx % W).to(torch.float32)
    yp = torch.div(peak_idx, W, rounding_mode="floor").to(torch.float32)

    wsafe = torch.clamp(wsum, min=1e-9)
    xc = torch.where(has_peak, xp, wx / wsafe)
    yc = torch.where(has_peak, yp, wy / wsafe)
    x2 = torch.clamp(x2c, min=1e-6)
    y2 = torch.clamp(y2c, min=1e-6)
    xy = xyc
    t1 = 0.5 * (x2 + y2)
    t2 = torch.sqrt(torch.clamp(0.25 * (x2 - y2) ** 2 + xy ** 2, min=0.0))
    elong = torch.sqrt(torch.clamp(t1 + t2, min=1e-6)
                       / torch.clamp(t1 - t2, min=1e-6))

    # PSF flux at the (rounded) centroid pixel
    xi = torch.clamp(torch.round(xc).to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(torch.round(yc).to(torch.int32), 0, H - 1).long()
    sign = torch.where(pos_sum >= neg_sum, 1, -1).to(torch.int32)

    ids = torch.arange(1, p.max_transients + 1, device=dev)
    in_range = ids <= n
    vet_npix = (npix >= p.npix_min) & (npix <= p.npix_max) & ~truncated
    vet_shape = elong < p.elong_max
    # dipole: both signs significant within one segment (astrometric
    # residual artefact) — vetted out
    both = torch.minimum(pos_sum, neg_sum) / torch.clamp(
        torch.maximum(pos_sum, neg_sum), min=1e-9)
    vet_dipole = both < p.dipole_frac
    valid = in_range & vet_npix & vet_shape & vet_dipole

    cat = {
        "x": xc, "y": yc, "npix": npix, "elong": elong,
        "scorr_peak": Scorr[yi, xi], "scorr_peak_abs": peak_abs,
        "flux_psf": Fpsf[yi, xi], "fluxerr_psf": Fpsferr[yi, xi],
        "d_peak": D[yi, xi], "sign": sign,
        "valid": valid,
        "vetted_out": in_range & ~valid,
    }
    return cat, torch.sum(valid, dtype=torch.int32)


def transient_stats(cat, n_transients):
    """Header-level transient summary (T-NTRANS / T-FTRANS analogues)."""
    v = cat["valid"]
    return {
        "t_ntrans": n_transients,
        "t_npos": torch.sum(v & (cat["sign"] > 0), dtype=torch.int32),
        "t_nneg": torch.sum(v & (cat["sign"] < 0), dtype=torch.int32),
        "t_nvetted": torch.sum(cat["vetted_out"], dtype=torch.int32),
    }
