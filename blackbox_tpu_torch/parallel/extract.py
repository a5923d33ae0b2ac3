"""Tile-sharded source extraction: one mosaic over column blocks (port of
:mod:`blackbox_tpu.parallel.extract`).

The pixel-bound extraction stages (background mesh, mini2back, matched
filter, threshold, connected-component labels) run on column blocks
with halo exchanges; the per-source tail
(:func:`blackbox_tpu_torch.pipeline.reduce.catalog_tail`, K4 inside)
then runs once, on the mesh's first device, over the gathered planes,
so the sharded path is bit for bit :func:`extract_catalog` there:

* box statistics are box-local, but CUDA's ``cumsum`` adds a row in an
  order that depends on how many rows the call holds (measured: a
  column block's box STDs differ from the frame's by 7.6e-6 e- on the
  card), and that moves threshold pixels; so the rows the statistics
  read (every 8th at the production box) are gathered and the
  statistics run once, on the first device, as the dense path runs
  them (the JAX package gathers each shard's mesh instead);
* the mesh's NaN fill and median filter run on the gathered mesh;
* mini2back runs at full width on each device and is sliced: a sliced
  weight matrix would change the matmul's shape and its rounding;
* the matched filter's column pass reads a ``radius``-column halo
  (zeros at the frame's edges, the single-device zero pad);
* labels are global flat-index labels; each of the ``label_iters``
  steps exchanges a one-column halo, so step k of a block sees what
  step k of the whole frame sees (plain min-pooling: the JAX package
  uses ``reduce_window`` here, not its kernel).
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.parallel.mesh import (Mesh, _neighbour_cols,
                                              join_cols, split_cols)


def _halo_cols_fill(blocks, halo: int, fill) -> list:
    """Column halo exchange with a CONSTANT fill at the frame's edges
    (stencils that zero-pad, unlike the edge-repeating
    :func:`blackbox_tpu_torch.parallel.mesh.halo_exchange_cols`)."""
    def edge(b):
        return torch.full((b.shape[0], halo), fill, dtype=b.dtype,
                          device=b.device)

    return _neighbour_cols(blocks, halo, edge, edge)


def extract_pixel_stages_sharded(ctx, sci, mask_m, mesh: Mesh,
                                 axis_name: str = "tile"):
    """Sharded background + detection of an (H, W) frame.  Returns
    (sub, bkg, bstd, seg, n, mesh_med, mesh_std), each gathered onto the
    axis's first device."""
    from blackbox_tpu_torch.ops.background import (_mesh_median_filter,
                                                   box_rows, mini2back,
                                                   sampled_box_stats)
    from blackbox_tpu_torch.ops.detection import (_conv1d,
                                                  gaussian_kernel1d)
    from blackbox_tpu_torch.ops.stats import nanmedian

    H, W = sci.shape
    devs = mesh.axis_devices(axis_name)
    n_tile = len(devs)
    W_local = W // n_tile
    box = ctx.bkg_boxsize
    if W % n_tile or W_local % box:
        raise ValueError(
            f"width {W} must split into {n_tile} shards of whole "
            f"{box}-px background boxes")
    p = ctx.det_params
    taps = tuple(gaussian_kernel1d(p.fwhm_filter).tolist())
    r = (len(taps) - 1) // 2
    big = H * W + 2
    dev0 = devs[0]
    sci_b = split_cols(sci, devs)
    mask_b = split_cols(mask_m, devs)

    # ---- background: box stats of the gathered sampled rows ----
    rows, step = box_rows(H, box)
    med, std = sampled_box_stats(
        join_cols([s[rows] for s in sci_b], dev0),
        join_cols([m[rows] != 0 for m in mask_b], dev0), box, step,
        nsigma=ctx.bkg_nsigma)
    med = torch.nan_to_num(med, nan=float(nanmedian(med)))
    std = torch.nan_to_num(std, nan=float(nanmedian(std)))
    if ctx.bkg_filtersize > 1:
        med = _mesh_median_filter(med, ctx.bkg_filtersize)
        std = _mesh_median_filter(std, ctx.bkg_filtersize)
    # mini2back at full width once a device, then each block's columns
    full = {}
    bkg_b, bstd_b = [], []
    for i, d in enumerate(devs):
        if d not in full:
            full[d] = (mini2back(med.to(d), (H, W), box),
                       mini2back(std.to(d), (H, W), box))
        cols = slice(i * W_local, (i + 1) * W_local)
        bkg_b.append(full[d][0][:, cols])
        bstd_b.append(full[d][1][:, cols])
    del full
    sub_b = [s - b for s, b in zip(sci_b, bkg_b)]

    # ---- matched filter: rows are whole in a block; the column pass
    # reads an r-column halo, zeros at the frame's edges ----
    fy = [_conv1d(s, taps, 0) for s in sub_b]
    det_b = []
    for fyp, bs, m in zip(_halo_cols_fill(fy, r, 0.0), bstd_b, mask_b):
        filt = torch.zeros((H, W_local), dtype=fyp.dtype, device=fyp.device)
        for i, t in enumerate(taps):
            filt = filt + t * fyp[:, i:i + W_local]
        excl = (m & (maskbits.EDGE | maskbits.BAD
                     | maskbits.SATELLITE)) != 0
        det_b.append((filt > p.nsigma * torch.clamp(bs, min=1e-6)) & ~excl)
    del fy

    # ---- labels: global flat-index labels, a one-column halo a step ----
    gidx_b = []
    for i, d in enumerate(det_b):
        cols = torch.arange(i * W_local, (i + 1) * W_local,
                            dtype=torch.int32, device=d.device)
        gidx_b.append(torch.arange(H, dtype=torch.int32,
                                   device=d.device)[:, None] * W
                      + cols[None, :] + 1)
    lab_b = [torch.where(d, g, big) for d, g in zip(det_b, gidx_b)]
    for _ in range(p.label_iters):
        nxt = []
        for lp, d in zip(_halo_cols_fill(lab_b, 1, big), det_b):
            pr = torch.nn.functional.pad(lp, (0, 0, 1, 1), value=big)
            nb = torch.minimum(torch.minimum(pr[:-2], pr[1:-1]), pr[2:])
            nb = torch.minimum(torch.minimum(nb[:, :-2], nb[:, 1:-1]),
                               nb[:, 2:])
            nxt.append(torch.where(d, nb, big))
        lab_b = nxt
    seg_b = [torch.where(d, lab, 0) for d, lab in zip(det_b, lab_b)]
    n = sum(torch.sum(d & (lab == g), dtype=torch.int32).to(dev0)
            for d, lab, g in zip(det_b, lab_b, gidx_b))
    return (join_cols(sub_b, dev0), join_cols(bkg_b, dev0),
            join_cols(bstd_b, dev0), join_cols(seg_b, dev0), n, med, std)


def extract_catalog_sharded(ctx, sci, mask_m, mesh: Mesh,
                            axis_name: str = "tile"):
    """Tile-sharded :func:`extract_catalog`: the sharded pixel stages,
    then the shared per-source tail once, on the axis's first device,
    over the gathered planes (the JAX package runs the tail replicated
    on every device, with the same result)."""
    from blackbox_tpu_torch.pipeline.reduce import catalog_tail

    sub, bkg, bstd, seg, n, med, std = extract_pixel_stages_sharded(
        ctx, sci, mask_m, mesh, axis_name)
    sci_r = sci.to(mesh.axis_devices(axis_name)[0])
    return catalog_tail(ctx, sci_r, sub, bkg, bstd, seg, n, med, std)
