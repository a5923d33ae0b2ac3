"""Overscan correction, batched over all channels (port of
:mod:`blackbox_tpu.ops.overscan`).

Per channel:

1. vertical overscan: 3-sigma-clipped row means -> 5-sigma-cleaned
   deg-3 polynomial over row index, subtracted from the whole channel
   (the median row mean when the fit has too few points);
2. level offset between vertical/horizontal overscans from the clipped
   mean of the right end of the horizontal strip;
3. read noise = clipped std of the subtracted vertical overscan;
4. horizontal overscan: per-column 2.5-sigma-clipped means with
   contamination masking (ML: bright-pixel threshold + dilation; BG:
   columns under near-saturated stars), then a deg-7 fit-and-reject at
   columns >= ``idx_switch`` and the clipped means (gaps filled by a
   weighted deg-5 fit) below it, subtracted per column.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench.reference.ops.polyfit import (polyfit_reject, polyfit_w,
                                            polyval_norm)
from portbench.reference.ops.stats import (masked_mean_std, masked_median,
                                          sigma_clip, sigma_clipped_mean_std)


@dataclasses.dataclass(frozen=True)
class OverscanParams:
    voscan_poldeg: int = 3
    hos_poldeg: int = 7
    fill_poldeg: int = 5
    idx_switch: int = 150       # spline/means region -> polynomial region
    overlap: int = 30
    nfirst_mean: int = 3        # first columns: adopt plain mean if valid
    dlevel_ncols: int = 300     # right-end h-overscan window for dlevel
    data_limit: float = 2000.0  # ML contamination threshold (ADU*gain)
    mode: str = "ML"            # 'ML' or 'BG' contamination strategy
    # BG mode: data rows adjacent to the overscan checked for saturation
    ypix_lim: tuple = (2640, 5280)
    sat_frac: float = 0.9
    # static per-channel split column of the reference's BG2 channel-9
    # fit; carried for parity with the JAX package, which does not read
    # it either
    split_col: Optional[np.ndarray] = None


def _clip_scale(params: OverscanParams, xch: int, ych: int) -> OverscanParams:
    """Scale pixel-count parameters for small test geometries."""
    if xch >= params.idx_switch + params.overlap and ych > params.ypix_lim[1]:
        return params
    s = xch / 1320.0
    return dataclasses.replace(
        params,
        idx_switch=max(int(params.idx_switch * s), 4),
        overlap=max(int(params.overlap * s), 2),
        dlevel_ncols=max(int(params.dlevel_ncols * s), 2),
        ypix_lim=(max(int(params.ypix_lim[0] * ych / 5280.0), 1),
                  max(int(params.ypix_lim[1] * ych / 5280.0), 2)),
    )


def overscan_correct(chan_data, os_vert, os_hori, satlevel_e=None,
                     params: OverscanParams = OverscanParams()):
    """Correct the channel stack for overscan structure.

    chan_data : (C, ych, xch) gain-corrected data sections [e-]
    os_vert   : (C, dy, wv) usable vertical-overscan columns [e-]
    os_hori   : (C, hh, dx) usable horizontal-overscan rows [e-]
    satlevel_e: (C,) channel saturation levels in e- (BG mode)

    Returns (corrected chan_data, stats) with the per-channel BIASM/RDN
    values, the vertical-fit coefficients and the frame BIASMEAN/RDNOISE.
    """
    C, ych, xch = chan_data.shape
    dy = os_vert.shape[1]
    nx = C // 2
    params = _clip_scale(params, xch, ych)
    dev = chan_data.device
    f32 = torch.float32

    # ---- vertical overscan ----------------------------------------------
    zero_mask = os_vert == 0
    row_clip = sigma_clip(os_vert, mask=zero_mask, axis=2)
    mean_vos_col, _ = masked_mean_std(os_vert, row_clip, axis=2)   # (C, dy)
    mean_vos_col = torch.nan_to_num(mean_vos_col)

    clip5 = sigma_clip(mean_vos_col, axis=1, sigma=5.0, iters=5)
    w_fit = (~clip5).to(f32)
    # exclude the overscan-overlap rows: bottom channels have them at
    # the top of the strip, top channels at the bottom
    rows = torch.arange(dy, device=dev)
    is_top = torch.arange(C, device=dev)[:, None] >= nx
    overlap_rows = torch.where(is_top, rows[None, :] < (dy - ych),
                               rows[None, :] >= ych)
    w_fit = w_fit * (~overlap_rows)

    y = torch.arange(dy, dtype=f32, device=dev)
    coef_v = polyfit_w(y, mean_vos_col, w_fit, params.voscan_poldeg,
                       x0=0.0, x1=float(dy - 1))              # (C, D)
    fit_vos = polyval_norm(coef_v, y, 0.0, float(dy - 1))     # (C, dy)

    nvalid = torch.sum(w_fit > 0, dim=1)
    fit_ok = (nvalid > params.voscan_poldeg) & \
        torch.all(torch.isfinite(fit_vos), dim=1)
    med_fallback = torch.nan_to_num(masked_median(mean_vos_col, clip5,
                                                  axis=1))
    fit_vos = torch.where(fit_ok[:, None], fit_vos, med_fallback[:, None])
    mean_vos = torch.where(fit_ok, torch.mean(fit_vos, dim=1), med_fallback)

    def rows_for(bottom, top):
        """(C, n) row indices into the dy-long fit for each stack."""
        return torch.cat([bottom.expand(nx, -1), top.expand(nx, -1)], dim=0)

    os_off = dy - ych                    # ysize_os
    ar = torch.arange(ych, device=dev)
    data_rows = rows_for(ar, ar + os_off)
    chan_data = chan_data - torch.gather(fit_vos, 1, data_rows)[:, :, None]
    os_vert = os_vert - fit_vos[:, :, None]
    hh = os_hori.shape[1]
    ah = torch.arange(hh, device=dev)
    hos_rows = rows_for(ah + (dy - hh), ah)
    os_hori = os_hori - torch.gather(fit_vos, 1, hos_rows)[:, :, None]

    # ---- level offset between the two overscans -----------------------
    ncols = xch
    right = os_hori[:, :, max(ncols - params.dlevel_ncols, 0):ncols]
    dlevel, _ = sigma_clipped_mean_std(right.reshape(C, -1), axis=1)
    os_hori = os_hori - torch.nan_to_num(dlevel)[:, None, None]

    # ---- read noise from the subtracted vertical overscan -------------
    _, std_vos = sigma_clipped_mean_std(
        os_vert.reshape(C, -1), mask=zero_mask.reshape(C, -1), axis=1)

    # ---- horizontal overscan ------------------------------------------
    data_hos = os_hori[:, :, :ncols]                       # (C, hh, ncols)

    if params.mode == "BG" and satlevel_e is not None:
        lim1, lim2 = params.ypix_lim
        near1 = torch.where(is_top, ar[None, :] < lim1,
                            ar[None, :] >= ych - lim1)     # (C, ych)
        near2 = torch.where(is_top, ar[None, :] < lim2,
                            ar[None, :] >= ych - lim2)
        hot = chan_data >= params.sat_frac * satlevel_e[:, None, None]
        n1 = torch.sum(hot & near1[:, :, None], dim=1)     # (C, ncols)
        n2 = torch.sum(hot & near2[:, :, None], dim=1)
        mask_sat_row = (n1 >= 3) | (n2 >= 10)
        mask_hos = mask_sat_row[:, None, :].expand(data_hos.shape)
    else:
        mask_sat_row = torch.zeros((C, ncols), dtype=torch.bool, device=dev)
        contam = data_hos > params.data_limit
        # columns bright over >= half the strip are detector features,
        # not star contamination: restore the isolated ones
        mask_x = torch.sum(contam, dim=1) > 0.5 * hh       # (C, ncols)
        nbr = torch.roll(mask_x, 1, dims=1) | torch.roll(mask_x, -1, dims=1)
        contam = contam & ~(mask_x & ~nbr)[:, None, :]
        # grow the contamination mask by 2 (3x3 dilation twice)
        for _ in range(2):
            contam = contam | torch.roll(contam, 1, dims=1) \
                | torch.roll(contam, -1, dims=1)
            contam = contam | torch.roll(contam, 1, dims=2) \
                | torch.roll(contam, -1, dims=2)
        mask_hos = contam

    col_clip = sigma_clip(data_hos, mask=mask_hos, axis=1, sigma=2.5)
    nvals = torch.sum(~col_clip, dim=1)                    # (C, ncols)
    mean_hos, std_hos = masked_mean_std(data_hos, col_clip, axis=1, ddof=1)
    mask_valid = nvals > 1
    err_hos = torch.where(mask_valid,
                          std_hos / torch.sqrt(torch.clamp(nvals, min=1)),
                          0.0)
    err_hos = torch.nan_to_num(err_hos)
    mean_hos = torch.nan_to_num(mean_hos)

    xcol = torch.arange(ncols, dtype=f32, device=dev) + 1.0
    isw, ovl = params.idx_switch, params.overlap
    colidx = torch.arange(ncols, device=dev)

    # --- polynomial region (x >= idx_switch - overlap) ---
    w_poly = (mask_valid & (colidx >= isw - ovl)[None, :]).to(f32)
    # 5-sigma pre-clean of the column means inside the region
    pre = sigma_clip(torch.where(w_poly > 0, mean_hos, torch.nan), axis=1,
                     sigma=5.0)
    w_poly = w_poly * (~pre)
    _, _, fit_poly = polyfit_reject(
        xcol, mean_hos, w_poly, params.hos_poldeg, err_hos,
        nreject_sigma=3.0, reject_iters=3, x0=1.0, x1=float(ncols))

    # --- low-x fill fit (gap filler standing in for the spline) ---
    in_fill = colidx < (isw + ovl)
    w_fill = torch.where(err_hos > 0, 1.0 / torch.clamp(err_hos, min=1e-6),
                         0.0)
    w_fill = w_fill * mask_valid * in_fill[None, :]
    # the reference zeroes the first three columns' weights when all
    # are valid
    first = colidx < params.nfirst_mean
    first_ok = torch.all(mask_valid[:, :params.nfirst_mean], dim=1)
    w_fill = torch.where(first[None, :] & first_ok[:, None], 0.0, w_fill)
    coef_fill = polyfit_w(xcol, mean_hos, w_fill, params.fill_poldeg,
                          x0=1.0, x1=float(isw + ovl))
    fit_fill = polyval_norm(coef_fill, xcol, 1.0, float(isw + ovl))

    # --- stitch the overscan model ---
    low = colidx < isw
    oscan = torch.where(low[None, :], fit_fill, fit_poly)
    use_mean = mask_valid & low[None, :]
    if params.mode == "BG":
        use_mean = use_mean & ~mask_sat_row
    oscan = torch.where(use_mean, mean_hos, oscan)
    oscan = torch.where(first[None, :] & mask_valid, mean_hos, oscan)

    chan_data = chan_data - oscan[:, None, :]

    stats = {
        "biasm": mean_vos,                    # (C,) BIASM1..16 [e-]
        "rdn": torch.nan_to_num(std_vos),     # (C,) RDN1..16   [e-]
        "biasmean": torch.nanmean(mean_vos),  # BIASMEAN
        "rdnoise": torch.nanmean(std_vos),    # RDNOISE
        "vfit_coef": coef_v,                  # (C, D) normalised-domain
        "vfit_ok": fit_ok,                    # (C,) VFITOK1..16
    }
    return chan_data, stats
