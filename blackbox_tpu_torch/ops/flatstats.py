"""Flat-field quality statistics on the device (port of
:mod:`blackbox_tpu.ops.flatstats`).

STATSEC and full-image masked median/STD, per-channel medians, and a
subimage grid of medians plus below-median STDs feeding the RDIF-MAX /
RSTD-MAX vignetting QC metrics, over every unmasked pixel.
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.ops.stats import masked_mean_std, masked_median


def flat_statistics(mosaic, mask, geom, statsec, subsize: int):
    """Compute flat statistics.

    mosaic  : (H, W) reduced flat [e-]
    mask    : (H, W) integer mask (0 = usable)
    statsec : (slice, slice) normalisation section
    subsize : subimage grid box size (ZOGY subimage_size)

    Returns a dict of device scalars / small arrays keyed like the header
    keywords they feed.
    """
    bad = mask != 0
    out = {}

    sec = mosaic[statsec].reshape(-1)
    sec_bad = bad[statsec].reshape(-1)
    med_sec = masked_median(sec, sec_bad, axis=0)
    _, std_sec = masked_mean_std(sec, sec_bad, axis=0)
    out["medsec"] = med_sec
    out["stdsec"] = std_sec
    out["rstdsec"] = std_sec / med_sec

    med = masked_median(mosaic.reshape(-1), bad.reshape(-1), axis=0)
    _, std = masked_mean_std(mosaic.reshape(-1), bad.reshape(-1), axis=0)
    out["flatmed"] = med
    out["flatstd"] = std
    out["flatrstd"] = std / med

    # per-channel stats on the channel stacks
    chan = geom.disassemble(mosaic)
    chan_bad = geom.disassemble(bad)
    C = chan.shape[0]
    out["flatm"] = masked_median(chan.reshape(C, -1),
                                 chan_bad.reshape(C, -1), axis=1)
    _, out["flats"] = masked_mean_std(chan.reshape(C, -1),
                                      chan_bad.reshape(C, -1), axis=1)
    out["flatrs"] = out["flats"] / out["flatm"]

    # subimage grid: medians and below-median STDs
    H, W = mosaic.shape
    ny, nx = H // subsize, W // subsize

    def tiles_of(a):
        return a[:ny * subsize, :nx * subsize].reshape(
            ny, subsize, nx, subsize).transpose(1, 2).reshape(ny, nx, -1)

    tiles = tiles_of(mosaic)
    tbad = tiles_of(bad)
    mini_med = masked_median(tiles, tbad, axis=2)            # (ny, nx)
    below = tbad | (tiles > mini_med[..., None])
    n = torch.sum(~below, dim=2)
    ss = torch.sum(torch.where(below, 0.0,
                               (tiles - mini_med[..., None]) ** 2), dim=2)
    mini_std = torch.sqrt(ss / torch.clamp(n - 1, min=1))

    # interior subimages only (erode the unit grid by one)
    interior = torch.zeros((ny, nx), dtype=torch.bool, device=mosaic.device)
    interior[1:-1, 1:-1] = ny > 2
    big = float("inf")
    mn = torch.min(torch.where(interior, mini_med, big))
    mx = torch.max(torch.where(interior, mini_med, -big))
    out["nsubstot"] = torch.tensor(ny * nx)
    out["nsubs"] = torch.sum(interior)
    out["rdif_max"] = torch.abs((mx - mn) / (mx + mn))
    rstd = torch.where(interior & (mini_med != 0),
                       mini_std / torch.abs(mini_med), -big)
    out["rstd_max"] = torch.max(rstd)
    return out
