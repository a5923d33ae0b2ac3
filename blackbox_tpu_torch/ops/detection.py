"""Source detection: matched filter, labeling, fixed-capacity catalog
(port of :mod:`blackbox_tpu.ops.detection`).

The background-subtracted image is convolved with a separable Gaussian
matched filter, thresholded at ``nsigma`` times the local background
STD, labelled by bounded min-label propagation (CUDA kernel on the
card), and per-segment moments are reduced over windows around each
segment's root pixel into a catalog of ``max_sources`` slots.

:func:`fused_detect` is the port of the fused TPU kernel
``pallas/detect.py``: filter, threshold, exclusion and labels in one
pass (CUDA kernel ``csrc/detect.cu`` on the card).  As in the JAX
package it is taken only when ``BBTPU_PALLAS_DETECT=1``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from blackbox_tpu_torch import kernels
from blackbox_tpu_torch.ops.labeling import (_KERNEL_STEPS, _MIN_TILE,
                                             _label_propagate_plain,
                                             label_components)
from blackbox_tpu_torch.ops.windows import gather_slot_windows


@dataclasses.dataclass(frozen=True)
class DetectParams:
    nsigma: float = 1.5
    npix_min: int = 3
    max_sources: int = 20000
    fwhm_filter: float = 3.0     # matched-filter FWHM [pix]
    # labeling steps bound the geodesic diameter that merges into one
    # segment; larger blobs split into a few segments
    label_iters: int = 32
    # two-tier moment windows: every segment gets a small window;
    # segments touching its border are redone in a big one
    moment_window: int = 32
    moment_window_big: int = 96
    nbig_max: int = 1024


def gaussian_taps(fwhm: float, radius: int | None = None) -> tuple:
    """Static Gaussian filter taps (python floats holding exact f32
    values, the JAX package's constants)."""
    sigma = fwhm / (2.0 * math.sqrt(2.0 * math.log(2.0)))
    if radius is None:
        radius = max(int(3 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    return tuple(float(v) for v in k)


def _conv1d(image, taps, dim: int):
    """1-D convolution as shifted adds (zero padding), taps in order."""
    r = (len(taps) - 1) // 2
    H, W = image.shape
    pad = (0, 0, r, r) if dim == 0 else (r, r)
    p = torch.nn.functional.pad(image, pad)
    out = torch.zeros_like(image)
    for i, t in enumerate(taps):
        sl = p[i:i + H, :] if dim == 0 else p[:, i:i + W]
        out = out + t * sl
    return out


def matched_filter(image, fwhm: float):
    """Separable Gaussian filter.  Returns (filtered image, noise shrink
    factor ``sum(k**2)``)."""
    taps = gaussian_taps(fwhm)
    out = _conv1d(_conv1d(image, taps, 0), taps, 1)
    k = torch.tensor(taps, dtype=torch.float32)
    return out, torch.sum(k ** 2)


def label_segments(det, label_iters: int = 48):
    """Label a boolean detection map.

    Returns (seg, n): ``seg`` holds 0 for background and the segment's
    ROOT label (flat index of its root pixel + 1) elsewhere.
    """
    lab = label_components(det, iters=label_iters)
    H, W = det.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=det.device).reshape(H, W)
    n = torch.sum(det & (lab == idx), dtype=torch.int32)
    return torch.where(det, lab, 0), n


def pallas_detect_enabled() -> bool:
    """The JAX package's switch for the fused detection kernel
    (``BBTPU_PALLAS_DETECT=1``), read at call time."""
    return os.environ.get("BBTPU_PALLAS_DETECT", "0") == "1"


def detect_segments(image_bksub, bkg_std, excl_mask,
                    params: DetectParams = DetectParams(),
                    use_pallas: bool | None = None):
    """Threshold + label.  Returns (seg (H, W) int32, n_sources).

    ``use_pallas=None`` takes the fused kernel (:func:`fused_detect`)
    under the JAX package's rule: ``BBTPU_PALLAS_DETECT=1``,
    ``label_iters <= 56``, a frame of at least 512 x 512, and (in place
    of "the backend is a TPU") the image on a CUDA device.
    """
    p = params
    H, W = image_bksub.shape
    if use_pallas is None:
        use_pallas = (image_bksub.device.type == "cuda"
                      and p.label_iters <= 56 and H >= 512 and W >= 512
                      and pallas_detect_enabled())
    if use_pallas:
        return fused_detect(image_bksub, bkg_std, excl_mask,
                            gaussian_taps(p.fwhm_filter), p.nsigma,
                            iters=p.label_iters)
    filt, _ = matched_filter(image_bksub, p.fwhm_filter)
    # compared against nsigma times the UNFILTERED background RMS
    det = filt > p.nsigma * torch.clamp(bkg_std, min=1e-6)
    if excl_mask is not None:
        det = det & ~excl_mask
    return label_segments(det, p.label_iters)


def _fused_detect_plain(image, bkg_std, excl, taps, nsigma: float,
                        iters: int, absval: bool):
    """Plain version of :func:`fused_detect`: the unfused chain (filter,
    threshold, exclusion, ``iters`` plain label steps, root count)."""
    H, W = image.shape
    x = image
    if taps is not None:
        x = _conv1d(_conv1d(x, taps, 0), taps, 1)
    if absval:
        x = torch.abs(x)
    if bkg_std is not None:
        det = x > nsigma * torch.clamp(bkg_std, min=1e-6)
    else:
        det = x > nsigma
    if excl is not None:
        det = det & ~excl.to(torch.bool)
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=image.device).reshape(H, W)
    lab = _label_propagate_plain(torch.where(det, idx, H * W + 2), iters)
    n = torch.sum(det & (lab == idx), dtype=torch.int32)
    return torch.where(det, lab, 0), n


def fused_detect(image, bkg_std, excl, taps, nsigma: float,
                 iters: int = 32, absval: bool = False):
    """Matched filter + threshold + connected-component labels, fused.

    image   : (H, W) f32 map to detect on.
    bkg_std : (H, W) f32 or None — threshold is
              ``nsigma * max(bkg_std, 1e-6)`` (None: scalar ``nsigma``).
    excl    : (H, W) bool mask or None — True pixels excluded.
    taps    : tuple of float filter taps (odd length), or None.
    absval  : threshold ``|image|`` (transient Scorr detection).

    Returns (seg (H, W) int32 — 0 background, root flat index + 1
    labels — and n, the int32 root count as a 0-d device tensor),
    identical to :func:`label_segments` on the thresholded map.  CPU
    tensors take the plain version; CUDA tensors run ``csrc/detect.cu``
    (a scan that thresholds and lists the tiles with a detection, then
    the label steps on the listed tiles; 0 to 64 steps).
    """
    if image.device.type == "cpu":
        return _fused_detect_plain(image, bkg_std, excl, taps, nsigma,
                                   iters, absval)
    H, W = image.shape
    img = image.to(torch.float32).contiguous()
    std = (None if bkg_std is None
           else bkg_std.to(torch.float32).contiguous())
    exc = None
    if excl is not None:
        # a bool mask is read as its bytes (0/1), without a copy
        exc = (excl if excl.dtype == torch.bool else excl != 0)
        exc = exc.contiguous().view(torch.uint8)
    ops = [t for t in (img, std, exc) if t is not None]
    kernels.require_cuda("fused_detect", *ops)
    if any(t.shape != (H, W) for t in ops):
        raise ValueError("fused_detect: image, std and excl must share "
                         "one (H, W) shape")
    if not 0 <= iters <= _KERNEL_STEPS:
        raise ValueError(f"fused_detect: {iters} label steps; the kernel "
                         f"takes 0 to {_KERNEL_STEPS}")
    dev = img.device
    seg = torch.empty((H, W), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    # the scan's detection map and its list of tiles with a detection
    det = torch.empty((H, W), dtype=torch.uint8, device=dev)
    work = torch.empty(1 + -(-H // _MIN_TILE) * -(-W // _MIN_TILE),
                       dtype=torch.int32, device=dev)
    ntaps = 0 if taps is None else len(taps)
    taps_host = kernels.host_floats(taps) if ntaps else None
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().bbt_fused_detect(
            img.data_ptr(), None if std is None else std.data_ptr(),
            None if exc is None else exc.data_ptr(), taps_host, ntaps,
            float(nsigma), int(absval), int(iters), H, W, det.data_ptr(),
            work.data_ptr(), seg.data_ptr(), count.data_ptr(),
            kernels.stream_of(img)), "fused_detect")
    fused_detect.launches += 1
    return seg, count


fused_detect.launches = 0


def segment_roots(seg, max_sources: int):
    """Flat raster index of the k-th segment's root pixel, k = 1..max.

    A pixel is a root iff ``seg == its flat index + 1``, and roots
    appear in raster order, so an integer running count over the frame
    and a search for each k give the k-th root.  For k past the last
    root the index clamps to ``H*W - 1``; callers gate on k <= n.
    """
    H, W = seg.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=seg.device).reshape(H, W)
    cnt = torch.cumsum((seg == idx).reshape(-1), 0, dtype=torch.int32)
    ks = torch.arange(1, max_sources + 1, dtype=torch.int32,
                      device=seg.device)
    pos = torch.searchsorted(cnt, ks, side="left")
    return torch.clamp(pos, 0, H * W - 1).to(torch.int32)


def segment_catalog(image_bksub, bkg_std, seg, n_sources,
                    params: DetectParams = DetectParams(), roots=None):
    """First/second moments + peak per segment, fixed capacity.

    Returns a dict of (max_sources,) tensors: x, y (centroids, 0-based),
    flux_iso, npix, peak, x2, y2, xy (central second moments), valid.
    """
    p = params
    H, W = seg.shape
    dev = seg.device
    root = roots if roots is not None else segment_roots(seg, p.max_sources)
    rootval = seg.reshape(-1)[root]
    ry = torch.div(root, W, rounding_mode="floor").to(torch.int32)
    rx = (root % W).to(torch.int32)
    ks = torch.arange(1, p.max_sources + 1, dtype=torch.int32, device=dev)

    win = min(p.moment_window, H, W)
    (xc, yc, flux, npix, peak, x2, y2, xy, trunc) = _window_moments(
        image_bksub, seg, rootval, ry, rx, win, n_active=n_sources)

    # tier 2: segments touching the small window's border are redone in
    # a big window (the bright tail)
    win_big = min(p.moment_window_big, H, W)
    if win_big > win and p.nbig_max > 0:
        cnt = torch.cumsum(trunc, 0, dtype=torch.int32)
        kb = torch.arange(1, p.nbig_max + 1, dtype=torch.int32, device=dev)
        slots = torch.clamp(torch.searchsorted(cnt, kb, side="left"),
                            0, p.max_sources - 1)
        outb = _window_moments(image_bksub, seg, rootval[slots], ry[slots],
                               rx[slots], win_big, n_active=cnt[-1])
        # unused kb entries write to one spare slot past the end, which
        # is dropped
        slots_ok = torch.where(kb <= cnt[-1], slots, p.max_sources)

        def put(a, b):
            ext = torch.cat([a, a.new_zeros(1)])
            ext[slots_ok] = b
            return ext[:p.max_sources]

        xc, yc, flux, npix, peak, x2, y2, xy = (
            put(a, b) for a, b in zip((xc, yc, flux, npix, peak, x2, y2, xy),
                                      outb[:8]))

    valid = (ks <= n_sources) & (npix >= p.npix_min)
    return {"x": xc, "y": yc, "flux_iso": flux, "npix": npix, "peak": peak,
            "x2": x2, "y2": y2, "xy": xy, "valid": valid}


def _window_moments(image_bksub, seg, rootval, ry, rx, win: int,
                    n_active=None):
    """Windowed per-segment moments over all slots at once; the last
    return is the window-truncation flag (segment touches the border).
    Slots at or past ``n_active`` see zero windows."""
    H, W = seg.shape
    # the root is a segment's topmost-then-leftmost pixel: bias the
    # window down so the blob (which extends downward) stays inside
    y0 = torch.clamp(ry - win // 3, 0, H - win)
    x0 = torch.clamp(rx - win // 2, 0, W - win)
    g = torch.arange(win, dtype=torch.float32, device=seg.device)
    sw, vw = gather_slot_windows((seg, image_bksub), y0, x0, win,
                                 n_active=n_active)
    k = rootval[:, None, None]
    m = (sw == k) & (k > 0)
    mf = m.to(torch.float32)
    npix = torch.sum(mf, dim=(1, 2))
    flux = torch.sum(vw * mf, dim=(1, 2))
    peak = torch.amax(torch.where(m, vw, -torch.inf), dim=(1, 2))
    w = torch.clamp(vw, min=0.0) * mf                # positive weights
    # window-local coordinates: absolute x^2 ~ 1e8 would swamp the
    # few-px^2 central moments in f32
    yy = g[None, :, None]
    xx = g[None, None, :]
    wsum = torch.clamp(torch.sum(w, dim=(1, 2)), min=1e-9)
    xl = torch.sum(w * xx, dim=(1, 2)) / wsum
    yl = torch.sum(w * yy, dim=(1, 2)) / wsum
    dxl = xx - xl[:, None, None]
    dyl = yy - yl[:, None, None]
    x2 = torch.sum(w * dxl ** 2, dim=(1, 2)) / wsum
    y2 = torch.sum(w * dyl ** 2, dim=(1, 2)) / wsum
    xy = torch.sum(w * dxl * dyl, dim=(1, 2)) / wsum
    xc = xl + x0.to(torch.float32)
    yc = yl + y0.to(torch.float32)
    border = (m[:, 0, :].any(1) | m[:, -1, :].any(1)
              | m[:, :, 0].any(1) | m[:, :, -1].any(1))
    return (xc, yc, flux, npix, torch.where(npix > 0, peak, 0.0),
            x2, y2, xy, border & (npix > 0))


def moments_shape(cat):
    """A/B axes, elongation, FWHM estimate from second moments."""
    x2, y2, xy = cat["x2"], cat["y2"], cat["xy"]
    t1 = 0.5 * (x2 + y2)
    t2 = torch.sqrt(torch.clamp(0.25 * (x2 - y2) ** 2 + xy ** 2, min=0.0))
    a2 = torch.clamp(t1 + t2, min=1e-6)
    b2 = torch.clamp(t1 - t2, min=1e-6)
    a = torch.sqrt(a2)
    b = torch.sqrt(b2)
    fwhm = 2.0 * torch.sqrt(math.log(2.0) * (a2 + b2))
    theta = 0.5 * torch.atan2(2 * xy, x2 - y2)
    return {"a": a, "b": b, "elong": a / b, "fwhm": fwhm, "theta": theta}
