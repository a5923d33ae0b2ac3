"""Reference-image building: input selection + device co-addition (port
of :mod:`blackbox_tpu.pipeline.buildref`).

1. **Selection** (host, :func:`select_images`): per field x filter, cut
   the header-table index on QC flag, seeing and tracking, pick the
   largest seeing-coherent subset (≤ max_spread), sort by limiting
   magnitude and keep images until the projected co-add depth stops
   improving by more than ``dlimmag_proj_min``.
2. **Co-addition** (device): remap each input onto the output TAN grid
   (two-pass Lanczos-3 shifted adds, or the exact gathers), scale to a
   common zeropoint, weight by inverse variance with discard-bit
   zeroing, Gruen-clipped weighted mean, mask voting.
   :func:`coadd_field` holds the whole stack on the device;
   :func:`coadd_field_blocked`, the production path of
   :func:`build_reference` (every full-frame co-add of three or more
   inputs is over its 4e9-byte switch), streams row slabs from host
   memory through a 1-deep pipeline of pinned buffers.
3. **Publication** (:func:`build_reference`): limiting magnitude, the
   not-deeper gate against the field's current reference (archived to
   ``ref-old/``, not deleted), the header and its QC check, the
   catalog and PSF of the co-add when an extraction context is given,
   and the Rice products.

The pixel work runs on ``device``, the card unless the caller asks for
another (``device="cpu"``, where every kernel takes its plain version).
:func:`select_images` and :func:`choose_clip_params` are the JAX
package's host code, copied (``tests/test_torch_import.py`` holds them
equal).  This module's :class:`BuildRefSettings` is its own, as in the
JAX package; ``config.defaults.BuildRefSettings`` is a different class.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.ops.coadd import (
    ClipParams, a_swarp_search, clipped_coadd, coadd_bkg_std, coadd_mask,
    saturation_protect, weighted_coadd)
from blackbox_tpu_torch.ops.warp import (
    grid_shift_ranges, lanczos_resample, nearest_resample, remap_grid,
    remap_grid_coarse, upsample_grid, warp_shift2pass)
from blackbox_tpu_torch.utils.timing import span

log = logging.getLogger(__name__)

_MODES = ("lanczos", "nearest", "nearest")
_FILLS = (0.0, 0.0, maskbits.EDGE)


@dataclasses.dataclass(frozen=True)
class BuildRefSettings:
    """The reference's set_buildref settings."""

    combine_type: str = "clipped"
    max_spread_seeing: float = 0.3
    seeing_max: float = 4.0              # per-filter cap, ″
    # no qc_flag_max cut by default; red frames never publish real
    # catalogs anyway
    qc_accept: tuple = ("green", "yellow", "orange")
    limmag_target: float = 23.0
    dmag: float = 0.5
    dlimmag_proj_min: float = 0.002      # marginal-gain cut
    nimages_min: int = 3
    nimages_max: int = 40
    masktype_discard: int = 63           # BAD|CR|SAT|SATCON|SATL|EDGE
    pixscale_out: float = 0.5642
    clip: ClipParams = ClipParams()
    # observatory sites (lat, lon[deg E], height[m]) per telescope; the
    # night date of an input's products uses the site longitude
    site: Any = dataclasses.field(default_factory=lambda: {
        "ML": (-32.3799, 20.8112, 1802.0),
        "BG": (-29.2575, -70.7380, 2383.0),
    })


@dataclasses.dataclass
class RefInput:
    """One co-add input: pixel planes (tensors on any device, or numpy)
    and host metadata."""

    image: Any                  # (H, W) calibrated, background-SUBTRACTED
    bkg_std: Any                # (H, W)
    mask: Any                   # (H, W) uint8
    wcs: object                 # TanWCS
    zp: float                   # photometric zeropoint [mag]
    airmass: float = 1.0
    extco: float = 0.0          # extinction coefficient [mag/airmass]
    gain: float = 1.0
    rdnoise: float = 10.0
    saturate: float = 55000.0
    fwhm_pix: float = 4.0       # seeing FWHM [pix] (clip protection)
    psf_stamp: Optional[np.ndarray] = None   # (S, S) centre PSF
    # Optional compact background-STD representation: the (ny, nx)
    # sigma-clipped mesh whose Catmull-Rom upsample is bkg_std
    # (ops.background.mini2back).  When every input carries it, the
    # blocked combiner rebuilds each std slab on the device from the
    # resident meshes instead of streaming full-res std planes (4 of
    # the 9 host->device bytes a pixel).
    bkg_std_mini: Optional[np.ndarray] = None   # (ny, nx) float32
    bkg_boxsize: int = 0                        # mesh box size [px]


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _on(v, dev, dtype):
    return torch.as_tensor(v, device=dev).to(dtype)


def _sigma(bkg_std, f) -> float:
    """An input's noise scale in the common flux scale: the median of
    its every 4th background-STD pixel times its flux scale."""
    sub = bkg_std[::4, ::4]
    return float(np.median(_host(sub))) * f


def select_images(table: Sequence[dict],
                  s: BuildRefSettings = BuildRefSettings()):
    """Pick co-add inputs from header-table rows of one field x filter.

    Each row needs: QC-FLAG, S-SEEING ["], LIMMAG [mag], and anything the
    caller wants back.  Returns the selected rows, LIMMAG-sorted.
    """
    def _f(v, default):
        try:
            x = float(v)
            return x if np.isfinite(x) else default
        except (TypeError, ValueError):
            return default

    rows = [r for r in table
            if str(r.get("QC-FLAG", "red")).lower() in s.qc_accept
            and _f(r.get("S-SEEING"), 99.0) < s.seeing_max
            and np.isfinite(_f(r.get("LIMMAG"), np.nan))
            # keep only frames tracked at sidereal rate; rows without
            # the column are assumed tracking
            and bool(r.get("ISTRACKI", True))]
    if not rows:
        return [], {"nsel": 0, "limmag_proj": None}

    # largest subset with seeing spread <= max_spread: slide a window
    # over the sorted seeing values
    see = np.array([float(r["S-SEEING"]) for r in rows])
    order = np.argsort(see)
    best_lo, best_hi = 0, 1
    for lo in range(len(order)):
        hi = lo
        while (hi + 1 <= len(order) - 1
               and see[order[hi + 1]] <= see[order[lo]]
               * (1 + s.max_spread_seeing)):
            hi += 1
        if hi - lo > best_hi - best_lo:
            best_lo, best_hi = lo, hi
    rows = [rows[i] for i in order[best_lo:best_hi + 1]]

    # deepest first; accumulate projected depth in flux space
    rows.sort(key=lambda r: -float(r["LIMMAG"]))
    sel = []
    cum_flux = 0.0
    limmag_proj = None
    for r in rows:
        lm = float(r["LIMMAG"])
        # projected co-add limiting magnitude: the limiting flux scales
        # with the co-add noise, σ_co² = 1/Σ(1/σ_i²) with σ_i ∝
        # 10^(-0.4·lm_i)  ->  limmag_proj = 1.25·log10(Σ 10^(0.8·lm_i))
        # (N equal frames gain 1.25·log10 N mag)
        cum_flux += 10.0 ** (0.8 * lm)
        new_proj = 1.25 * np.log10(cum_flux)
        if len(sel) >= s.nimages_min:
            if new_proj > s.limmag_target + s.dmag:
                sel.append(r)
                limmag_proj = new_proj
                break
            if limmag_proj is not None \
                    and new_proj - limmag_proj < s.dlimmag_proj_min:
                break
        sel.append(r)
        limmag_proj = new_proj
        if len(sel) >= s.nimages_max:
            break
    return sel, {"nsel": len(sel), "limmag_proj": limmag_proj}


def _flux_scale(inp: RefInput, zp_ref: float) -> float:
    # flux scale to the common zeropoint: zp_i less the extinction
    zp_i = inp.zp - inp.extco * (inp.airmass - 1.0)
    return 10.0 ** (0.4 * (zp_ref - zp_i))


def _weights(mask_stack, std_stack, discard: int):
    """Inverse-variance weights, zero on discard bits and no-data."""
    bad = ((mask_stack & discard) != 0) | (std_stack <= 0)
    return torch.where(bad, 0.0, 1.0 / torch.clamp(std_stack, min=1e-6) ** 2)


def _protect_radius(inputs, s: BuildRefSettings) -> int:
    return int(np.ceil(s.clip.protect_radius_fwhm
                       * max(inp.fwhm_pix for inp in inputs)))


def coadd_field(inputs: Sequence[RefInput], out_wcs, out_shape,
                s: BuildRefSettings = BuildRefSettings(),
                zp_ref: Optional[float] = None,
                remap: str = "shift2pass", device="cuda"):
    """Remap + scale + combine one field's inputs on the output grid,
    with the whole stack resident on ``device``.

    remap="shift2pass" (production): the two-pass variable-weight
    shifted-add resample (ops.warp.warp_shift2pass) on per-strip shift
    ranges; "gather" takes the exact 36-tap gather form.

    Returns a dict of tensors on ``device`` (image, bkg_std, mask, wsum,
    nclipped int32) and the per-input flux scales, zeropoint and count.
    """
    dev = torch.device(device)
    N = len(inputs)
    if N == 0:
        raise ValueError("no co-add inputs")
    if zp_ref is None:
        zp_ref = max(inp.zp for inp in inputs)

    imgs, stds, msks, fscales = [], [], [], []
    for inp in inputs:
        fs = _flux_scale(inp, zp_ref)
        srcs = (_on(inp.image, dev, torch.float32),
                _on(inp.bkg_std, dev, torch.float32),
                _on(inp.mask, dev, torch.uint8))
        if remap == "shift2pass":
            sy_c, sx_c, Wy_c, Wx_c = remap_grid_coarse(
                inp.wcs, out_wcs, out_shape)
            ranges = grid_shift_ranges(sy_c, sx_c, blocks=8)
            Wy = torch.as_tensor(Wy_c, device=dev)
            Wx = torch.as_tensor(Wx_c, device=dev)
            ys = upsample_grid(torch.as_tensor(sy_c, dtype=torch.float32,
                                               device=dev), Wy, Wx)
            xs = upsample_grid(torch.as_tensor(sx_c, dtype=torch.float32,
                                               device=dev), Wy, Wx)
            with span("warp"):
                img, std, msk = warp_shift2pass(srcs, _MODES, _FILLS,
                                                (ys, xs), ranges)
        else:
            ys, xs = (torch.as_tensor(g, device=dev)
                      for g in remap_grid(inp.wcs, out_wcs, out_shape))
            img = lanczos_resample(srcs[0], ys, xs)
            std = nearest_resample(srcs[1], ys, xs, fill=0.0)
            msk = nearest_resample(srcs[2], ys, xs, fill=maskbits.EDGE)
        del srcs, ys, xs
        imgs.append(img * fs)
        stds.append(std * fs)
        msks.append(msk)
        fscales.append(fs)
        del img, std

    stack = torch.stack(imgs)
    del imgs
    std_stack = torch.stack(stds)
    del stds
    mask_stack = torch.stack(msks)
    del msks

    w = _weights(mask_stack, std_stack, s.masktype_discard)
    del std_stack
    sigmas = [_sigma(inp.bkg_std, f) for inp, f in zip(inputs, fscales)]
    if s.combine_type == "clipped" and N >= s.clip.nmin_clip:
        protect = saturation_protect(mask_stack, _protect_radius(inputs, s))
        co, wsum, nclip = clipped_coadd(stack, w, sigmas, s.clip,
                                        protect=protect)
    else:
        co, wsum = weighted_coadd(stack, w)
        nclip = torch.zeros(tuple(out_shape), dtype=torch.int32, device=dev)
    del stack, w

    mask_co = coadd_mask(mask_stack)
    std_co = coadd_bkg_std(wsum)
    # off-frame: no weight anywhere
    mask_co = torch.where(wsum <= 0, mask_co | maskbits.EDGE, mask_co)

    return {
        "image": co, "bkg_std": std_co, "mask": mask_co,
        "wsum": wsum, "nclipped": nclip,
        "fscales": np.asarray(fscales, np.float32),
        "zp": float(zp_ref),
        "nimages": N,
    }


def coadd_field_blocked(inputs: Sequence[RefInput], out_wcs, out_shape,
                        s: BuildRefSettings = BuildRefSettings(),
                        zp_ref: Optional[float] = None,
                        block_rows: int = 1320, pad_rows: int = 256,
                        instrument: bool = False,
                        remap: str = "shift2pass", device="cuda"):
    """Row-blocked co-addition for stacks beyond device memory.

    Inputs stay in host memory; for each output row block every input
    contributes a fixed-height row slab (block + halo + pad for
    dither/rotation, clamped at the edges).  The block step remaps,
    scales and Gruen-clips the (N, rows, W) stack on ``device``; the
    outputs accumulate on the host (numpy).  Exactly
    :func:`coadd_field` semantics when every contribution fits the slab
    (checked per block; violations are logged and clipped to edge).

    The blocks run as a 1-deep software pipeline: the host fills block
    k+1's pinned slabs while the device combines block k, uploads are
    ``non_blocking``, and block k's results come back into pinned
    buffers on the same stream, drained on the host while block k+1
    computes.  ``instrument=True`` breaks the pipeline with a device
    synchronisation after each stage and returns ``timings``: the
    seconds of host preparation, upload, compute and drain, and the
    number of blocks.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    N = len(inputs)
    if N == 0:
        raise ValueError("no co-add inputs")
    if zp_ref is None:
        zp_ref = max(inp.zp for inp in inputs)
    H, W = out_shape
    block_rows = min(block_rows, H)

    imgs = [_host(inp.image).astype(np.float32, copy=False)
            for inp in inputs]
    msks = [_host(inp.mask).astype(np.uint8, copy=False) for inp in inputs]
    Hin, Win = imgs[0].shape

    # background-STD source: when every input carries its mini mesh,
    # the std slabs are rebuilt on the device from the resident meshes
    # and the Catmull-Rom weight matrices, which cuts the per-block
    # upload from 9 to 5 bytes a pixel
    use_mini = all(inp.bkg_std_mini is not None and inp.bkg_boxsize
                   for inp in inputs)
    use_mini = use_mini and len(
        {(np.shape(inp.bkg_std_mini), inp.bkg_boxsize)
         for inp in inputs}) == 1
    if use_mini:
        from blackbox_tpu_torch.ops.background import _catmull_rom_matrix
        box_std = inputs[0].bkg_boxsize
        stdm_stack = torch.as_tensor(np.stack(
            [np.asarray(inp.bkg_std_mini, np.float32) for inp in inputs]),
            device=dev)
        Wy_std = torch.tensor(_catmull_rom_matrix(
            Hin, stdm_stack.shape[1], box_std), device=dev)
        Wx_std = torch.tensor(_catmull_rom_matrix(
            Win, stdm_stack.shape[2], box_std), device=dev)
        stds = None
    else:
        stds = [_host(inp.bkg_std).astype(np.float32, copy=False)
                for inp in inputs]

    fscales = np.array([_flux_scale(inp, zp_ref) for inp in inputs],
                       np.float32)
    sigmas = torch.as_tensor(
        [_sigma(inp.bkg_std, f) for inp, f in zip(inputs, fscales)],
        dtype=torch.float32, device=dev)
    do_clip = s.combine_type == "clipped" and N >= s.clip.nmin_clip
    protect_radius = _protect_radius(inputs, s)
    # blocks carry a protect-radius halo so the saturation protection
    # seen by the clipping matches the unblocked coadd_field: without
    # it, a saturated star just outside the block would leave its PSF
    # wings unprotected across the seam
    ext = protect_radius if do_clip else 0
    # the halo start snaps down to the 32-px coarse remap lattice, so
    # the coordinate upsample interpolates between the same nodes as
    # the resident path (an unaligned origin moves coordinates by
    # ~1e-4 px and flips in-frame tests along the first/last column);
    # +32: the coarse node grid overshoots the block by up to one step,
    # and the slab must cover the overshoot node's source rows
    erows = block_rows + 2 * ext + 32
    slab_h = min(erows + 32 + 2 * pad_rows, Hin)

    # pre-pass: every block x input coarse grid (host WCS math), the
    # slab origins, and for shift2pass each call's global shift ranges
    # (blocks=1).  The JAX package takes the union of these ranges over
    # every block and input, so that one traced program serves them
    # all; eager calls need no common shape.  A tap outside a call's
    # own range has an exactly zero weight, so its own range sums the
    # same taps (rounded from a nearer centre): the union would span
    # the last block's slab offset (the slab is clamped to the frame,
    # ~600 rows above the block at full width) and cost ~30x the taps.
    grids = {}
    for b0 in range(0, H, block_rows):
        ey0 = max(0, ((b0 - ext) // 32) * 32)
        for i in range(N):
            sy_c, sx_c, Wy_b, Wx_b = remap_grid_coarse(
                inputs[i].wcs, out_wcs, (erows, W), y0=ey0)
            lo = int(np.floor(sy_c.min())) - 4
            hi = int(np.ceil(sy_c.max())) + 4
            if hi - lo > slab_h:
                log.warning("coadd block y=%d input %d: contribution "
                            "span %d exceeds slab %d (raise pad_rows)",
                            b0, i, hi - lo, slab_h)
            y0s = int(np.clip(lo, 0, max(Hin - slab_h, 0)))
            ranges = (grid_shift_ranges(sy_c - y0s, sx_c, blocks=1)
                      if remap == "shift2pass" else None)
            grids[(b0, i)] = (sy_c, sx_c, Wy_b, Wx_b, y0s, ranges)

    fs_dev = torch.as_tensor(fscales, device=dev)
    # the bilinear upsample matrices depend only on (erows, W) and the
    # 32-px step, the same for every block
    _, _, Wy_b, Wx_b, _, _ = grids[(0, 0)]
    Wy = torch.as_tensor(Wy_b, device=dev)
    Wx = torch.as_tensor(Wx_b, device=dev)

    def combine_block(dev_i, dev_s, dev_m, dev_cy, dev_cx, y0s_list,
                      ranges):
        # one input at a time into preallocated stacks: peak liveness
        # stays at one input's remap temporaries
        stack = torch.empty((N, erows, W), dtype=torch.float32, device=dev)
        std_b = torch.empty_like(stack)
        mask_b = torch.empty((N, erows, W), dtype=torch.uint8, device=dev)
        for i in range(N):
            if use_mini:
                # std slab rows y0s..y0s+slab_h of mini2back's
                # (Wy @ mesh) @ Wx.T
                y0s = y0s_list[i]
                st = torch.matmul(torch.matmul(
                    Wy_std[y0s:y0s + slab_h], stdm_stack[i]), Wx_std.T)
            else:
                st = dev_s[i]
            yl = upsample_grid(dev_cy[i], Wy, Wx)
            xl = upsample_grid(dev_cx[i], Wy, Wx)
            if remap == "shift2pass":
                with span("warp"):
                    img, std, m = warp_shift2pass(
                        (dev_i[i], st, dev_m[i]), _MODES, _FILLS, (yl, xl),
                        ranges[i])
            else:
                img = lanczos_resample(dev_i[i], yl, xl)
                std = nearest_resample(st, yl, xl, fill=0.0)
                m = nearest_resample(dev_m[i], yl, xl, fill=maskbits.EDGE)
            stack[i] = img * fs_dev[i]
            std_b[i] = std * fs_dev[i]
            mask_b[i] = m
            del img, std, m, st, yl, xl
        w = _weights(mask_b, std_b, s.masktype_discard)
        del std_b
        if do_clip:
            protect = saturation_protect(mask_b, protect_radius)
            co, wsum, nclip = clipped_coadd(stack, w, sigmas, s.clip,
                                            protect=protect)
        else:
            co, wsum = weighted_coadd(stack, w)
            nclip = torch.zeros(co.shape, dtype=torch.int32, device=dev)
        mask_co = coadd_mask(mask_b)
        mask_co = torch.where(wsum <= 0, mask_co | maskbits.EDGE, mask_co)
        # nclip <= N: uint8 on the way back when N fits (widened on
        # drain); more than 255 inputs keep int32 rather than wrap
        if N <= 255:
            nclip = nclip.to(torch.uint8)
        return co, wsum, nclip, mask_co

    out_img = np.zeros(out_shape, np.float32)
    out_wsum = np.zeros(out_shape, np.float32)
    out_nclip = np.zeros(out_shape, np.int32)   # widened on drain
    out_mask = np.zeros(out_shape, np.uint8)
    outs = (out_img, out_wsum, out_nclip, out_mask)

    def buffers(shapes_dtypes):
        return [torch.empty(shape, dtype=dt, pin_memory=cuda)
                for shape, dt in shapes_dtypes]

    # two sets of pinned slabs and result buffers, alternating: block
    # k+2 refills set k % 2 only after block k's results were drained,
    # which follows block k's upload on the stream
    nclip_dt = torch.uint8 if N <= 255 else torch.int32
    up_specs = [((N, slab_h, Win), torch.float32),
                ((N, slab_h, Win), torch.uint8)]
    if not use_mini:
        up_specs.append(((N, slab_h, Win), torch.float32))
    res_specs = [((block_rows, W), torch.float32),
                 ((block_rows, W), torch.float32),
                 ((block_rows, W), nclip_dt),
                 ((block_rows, W), torch.uint8)]
    up_bufs = [buffers(up_specs) for _ in range(2)]
    res_bufs = [buffers(res_specs) for _ in range(2)]

    tim = ({"prep_s": 0.0, "upload_s": 0.0, "compute_s": 0.0,
            "drain_s": 0.0, "nblocks": 0} if instrument else None)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def drain(pending):
        """Wait for a block's results and copy its interior (the
        protection halo cropped) into the host mosaics."""
        b0, hb, bufs, done = pending
        td = time.perf_counter()
        if done is not None:
            done.synchronize()
        for o, buf in zip(outs, bufs):
            o[b0:b0 + hb] = buf[:hb].numpy()
        if instrument:
            tim["drain_s"] += time.perf_counter() - td

    pending = None
    for k, b0 in enumerate(range(0, H, block_rows)):
        t0 = time.perf_counter()
        hb = min(block_rows, H - b0)
        ey0 = max(0, ((b0 - ext) // 32) * 32)
        off = b0 - ey0
        ups = up_bufs[k % 2]
        slab_views = [b.numpy() for b in ups]
        csys, csxs, y0s_list, ranges = [], [], [], []
        for i in range(N):
            sy_c, sx_c, _, _, y0s, rng_i = grids[(b0, i)]
            y0s_list.append(y0s)
            ranges.append(rng_i)
            slab_views[0][i] = imgs[i][y0s:y0s + slab_h]
            slab_views[1][i] = msks[i][y0s:y0s + slab_h]
            if not use_mini:
                slab_views[2][i] = stds[i][y0s:y0s + slab_h]
            # localise before the float32 cast
            csys.append((sy_c - y0s).astype(np.float32))
            csxs.append(sx_c.astype(np.float32))
        if instrument:
            t1 = time.perf_counter()
            tim["prep_s"] += t1 - t0
        dev_bufs = [b.to(dev, non_blocking=True) for b in ups]
        dev_cy = torch.as_tensor(np.stack(csys), device=dev)
        dev_cx = torch.as_tensor(np.stack(csxs), device=dev)
        if instrument:
            sync()
            t2 = time.perf_counter()
            tim["upload_s"] += t2 - t1
        res = combine_block(dev_bufs[0], None if use_mini else dev_bufs[2],
                            dev_bufs[1], dev_cy, dev_cx, y0s_list, ranges)
        del dev_bufs, dev_cy, dev_cx
        bufs = res_bufs[k % 2]
        for buf, r in zip(bufs, res):
            buf[:hb].copy_(r[off:off + hb], non_blocking=True)
        del res
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        if instrument:
            sync()
            tim["compute_s"] += time.perf_counter() - t2
            tim["nblocks"] += 1
        if pending is not None:
            drain(pending)
        pending = (b0, hb, bufs, done)
    if pending is not None:
        drain(pending)

    std_co = coadd_bkg_std(torch.from_numpy(out_wsum)).numpy()
    out = {
        "image": out_img, "bkg_std": std_co, "mask": out_mask,
        "wsum": out_wsum, "nclipped": out_nclip,
        "fscales": fscales, "zp": float(zp_ref), "nimages": N,
    }
    if instrument:
        out["timings"] = tim
    return out


def choose_clip_params(inputs: Sequence[RefInput],
                       s: BuildRefSettings = BuildRefSettings()):
    """A_swarp search over the inputs' centre PSF stamps."""
    stamps = [i.psf_stamp for i in inputs if i.psf_stamp is not None]
    if len(stamps) < 3:
        return s.clip
    arr = np.stack(stamps)
    A, ns, nout, nkept = a_swarp_search(arr, np.ones(len(arr), bool))
    return dataclasses.replace(s.clip, A=A, nsigma=ns)


def load_ref_input(red_path: str, bkg_boxsize: int = 256,
                   device="cuda") -> RefInput:
    """Load one published science product set as a co-add input.

    Reads the _red/_mask Rice products (and the _psf model, when there
    is one, for the centre PSF stamp), re-estimates the background on
    ``device`` (mesh + the Catmull-Rom upsample's two matmuls), and
    interpolates the saturated pixels (:func:`ops.filters.fixpix`)
    before the background is subtracted.  The planes of the returned
    input stay on ``device``.
    """
    import os
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.io.psffits import read_psf
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.ops.background import background_mesh, mini2back
    from blackbox_tpu_torch.ops.filters import fixpix
    from blackbox_tpu_torch.ops.psf import psf_at

    dev = torch.device(device)
    base = red_path[:red_path.index("_red.fits")]
    img, h = read_rice(red_path)
    mask, _ = read_rice(base + "_mask.fits.fz")
    img = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    mask = torch.as_tensor(np.asarray(mask, np.uint8), device=dev)

    box = min(bkg_boxsize, img.shape[0] // 4)
    mesh, stdm = background_mesh(img, mask != 0, box)
    bkg = mini2back(mesh, img.shape, box)
    bstd = mini2back(stdm, img.shape, box)

    psf_stamp = None
    psf_path = base + "_psf.fits"
    if os.path.exists(psf_path):
        model = read_psf(psf_path, device=dev)
        cy, cx = img.shape[0] / 2.0, img.shape[1] / 2.0
        psf_stamp = _host(psf_at(model, cx, cy))

    # saturated-pixel interpolation before stacking
    satbad = (mask & (maskbits.SATURATED | maskbits.SAT_CONNECTED)) != 0
    img = fixpix(img, satbad)

    # seeing FWHM in pixels for the clip-protection radius
    wcs = TanWCS.from_header(h)
    try:
        fwhm_pix = float(h.get("S-SEEING")) / max(wcs.pixscale, 1e-9)
    except (TypeError, ValueError):
        fwhm_pix = 4.0

    return RefInput(
        image=img - bkg, bkg_std=bstd, mask=mask,
        bkg_std_mini=_host(stdm).astype(np.float32), bkg_boxsize=box,
        wcs=wcs,
        zp=float(h.get("PC-ZP", 25.0)),
        airmass=float(h.get("AIRMASS", 1.0)),
        gain=float(h.get("GAIN", 1.0)),
        rdnoise=float(h.get("RDNOISE", 10.0)),
        saturate=float(h.get("SATURATE", 55000.0)),
        fwhm_pix=min(max(fwhm_pix, 1.0), 20.0),
        psf_stamp=psf_stamp)


def build_reference(tree, telescope: str, field_id: int, filt: str,
                    s: BuildRefSettings = BuildRefSettings(),
                    out_shape=None, pixscale: float = 0.5642,
                    dlimmag_min: float = 0.1, extract_ctx=None,
                    device="cuda"):
    """Full reference flow: select -> co-add -> QC -> publication gate.

    Inputs come from the header-table index; the new reference replaces
    an existing one only if its limiting magnitude improves by
    ``dlimmag_min`` (the old reference is archived under ``ref-old/``,
    not deleted).  With ``extract_ctx`` (a ReduceContext) the co-add's
    catalog and PSF are extracted on ``device`` and published beside
    it; the subtraction reads both.  Returns (status, info dict).
    """
    import os
    from blackbox_tpu_torch.astro.photcal import limiting_magnitude
    from blackbox_tpu_torch.config.base import get_par
    from blackbox_tpu_torch.io.fits import Header, write_image
    from blackbox_tpu_torch.io.rice import read_rice, write_rice
    from blackbox_tpu_torch.io.storage import get_backend, list_files
    from blackbox_tpu_torch.ops.stats import median
    from blackbox_tpu_torch.orchestration.headertable import query
    from blackbox_tpu_torch.orchestration.paths import night_date
    from blackbox_tpu_torch.qc.engine import run_qc_check
    from blackbox_tpu_torch.qc.ranges import QC_RANGES_REF

    dev = torch.device(device)
    rows = query(tree, telescope, "cat", OBJECT=str(field_id),
                 FILTER=filt)
    sel, info = select_images(rows, s)
    if len(sel) < s.nimages_min:
        return "too_few_images", {"nsel": len(sel)}

    # resolve product paths from the red tree via the night dates
    site = get_par(s.site, telescope)
    inputs, used = [], []
    for r in sel:
        date = night_date(float(r["MJD-OBS"]), site[1])
        rdir = tree.red_dir(date)
        p = os.path.join(rdir, str(r["FILENAME"]).replace(
            "_red.fits", "_red.fits.fz"))
        if not os.path.exists(p):
            continue
        inputs.append(load_ref_input(p, device=dev))
        used.append(os.path.basename(p))
    if len(inputs) < s.nimages_min:
        return "missing_products", {"nfound": len(inputs)}

    # output grid: the deepest input's WCS
    wcs_out = inputs[0].wcs
    shape = out_shape or tuple(int(n) for n in inputs[0].image.shape)

    sref = dataclasses.replace(s, clip=choose_clip_params(inputs, s))
    # resident stacks beyond ~4 GB go through the row-blocked streaming
    # combiner
    stack_bytes = len(inputs) * int(np.prod(shape)) * 4 * 3
    if stack_bytes > 4e9:
        out = coadd_field_blocked(inputs, wcs_out, shape, sref, device=dev)
        out = {k: (torch.as_tensor(v, device=dev)
                   if k in ("image", "bkg_std", "mask") else v)
               for k, v in out.items()}
    else:
        out = coadd_field(inputs, wcs_out, shape, sref, device=dev)
    del inputs

    # limiting magnitude of the co-add at its common zeropoint
    med_std = float(median(out["bkg_std"]))
    limmag = limiting_magnitude(out["zp"], med_std, 3.0, 1.0)
    out["limmag"] = limmag

    # improvement gate against the existing reference
    rdir = tree.ref_dir(field_id)
    existing = [f for f in list_files(os.path.join(rdir, "*_red.fits*"))
                if f"_{filt}_" in os.path.basename(f)]
    if existing:
        _, h_old = read_rice(existing[-1])
        old_lim = float(h_old.get("LIMMAG", -99.0))
        if limmag < old_lim + dlimmag_min:
            return "not_deeper", {"limmag": limmag, "old": old_lim}
        # archive, don't delete
        arch = os.path.join(rdir, "ref-old")
        be = get_backend(arch)
        be.make_dir(arch)
        for f in list_files(os.path.join(rdir, "*")):
            if get_backend(f).isfile(f):
                get_backend(f).copy(f, os.path.join(
                    arch, os.path.basename(f)))
                get_backend(f).remove(f)

    h = Header()
    h["IMAGETYP"] = ("ref", "reference co-add")
    h["OBJECT"] = (str(field_id), "field ID")
    h["FILTER"] = (filt, "filter")
    h["NIMAGES"] = (out["nimages"], "co-added images")
    h["PC-ZP"] = (round(out["zp"], 4), "[mag] common zeropoint")
    h["LIMMAG"] = (round(limmag, 4), "[mag] limiting magnitude")
    h["R-ASWARP"] = (sref.clip.A, "clipping amplitude A")
    h["R-NSIGMA"] = (sref.clip.nsigma, "clipping threshold")
    for i, name in enumerate(used[:40]):
        h[f"R-IM{i + 1}"] = (name, "input image")
    wcs_out.to_header(h)
    flag = run_qc_check(h, telescope, check_key_type="ref",
                        ranges_table=QC_RANGES_REF)

    get_backend(rdir).make_dir(rdir)
    stamp = f"{telescope}_{field_id:05d}_{filt}_coadd"

    # source extraction + PSF on the co-add: the catalog and PSF the
    # transient path consumes
    if extract_ctx is not None:
        from blackbox_tpu_torch.io.psffits import write_psf
        from blackbox_tpu_torch.pipeline.catalogs import (
            device_cat_to_columns, write_catalog)
        from blackbox_tpu_torch.pipeline.reduce import extract_catalog
        with torch.inference_mode():
            ext = extract_catalog(extract_ctx, out["image"], out["mask"])
        estats = {k: float(_host(v)) for k, v in ext["stats"].items()}
        h["NOBJECTS"] = (int(estats["nobjects"]), "detected sources")
        h["S-SEEING"] = (round(estats["s_seeing_pix"] * pixscale, 3),
                         "[arcsec] co-add seeing")
        cat = {k: _host(v) for k, v in ext["cat"].items()}
        cols = device_cat_to_columns(
            cat, out["zp"], wcs=wcs_out,
            n_aper=len(extract_ctx.apphot_radii))
        write_catalog(os.path.join(rdir, stamp + "_red_cat.fits"),
                      cols, h, "ref")
        if "psf" in ext:
            write_psf(os.path.join(rdir, stamp + "_psf.fits"),
                      ext["psf"], h)
        del ext

    red_p = os.path.join(rdir, stamp + "_red.fits.fz")
    write_rice(red_p, _host(out["image"]).astype(np.float32, copy=False), h,
               qlevel=16.0)
    write_rice(os.path.join(rdir, stamp + "_mask.fits.fz"),
               _host(out["mask"]).astype(np.uint8, copy=False), h)
    write_rice(os.path.join(rdir, stamp + "_bkgstd.fits.fz"),
               _host(out["bkg_std"]).astype(np.float32, copy=False), h,
               qlevel=8.0)
    write_image(os.path.join(rdir, stamp + "_red_hdr.fits"), None, h)

    return ("published" if flag != "red" else "red_flagged"), {
        "path": red_p, "limmag": limmag, "nimages": out["nimages"],
        "qc": flag}
