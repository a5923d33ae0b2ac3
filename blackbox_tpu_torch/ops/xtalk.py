"""Crosstalk correction as two channel contractions (port of
:mod:`blackbox_tpu.ops.xtalk`).

Victim correction is a linear mix of source-channel images: one
contraction with the same-row coefficients, one with the cross-row
coefficients on the y-flipped sources (the rows read out in mirror).
Source pixels contribute only where positive and not bad/cosmic;
victim pixels in the edge region are left untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from blackbox_tpu_torch.core import maskbits


def xtalk_correct(chan_data, mask, coeffs, nx: int = 8):
    """Subtract crosstalk from a channel stack.

    chan_data : (C, ych, xch) [e-];  mask : same-shape uint8 or None
    coeffs    : (C, C), source along axis 0, victim along axis 1
    """
    coeffs = torch.as_tensor(coeffs, dtype=chan_data.dtype,
                             device=chan_data.device)
    if mask is None:
        src = torch.clamp(chan_data, min=0.0)
        victim_ok = None
    else:
        bad = (mask & (maskbits.BAD | maskbits.COSMIC)) != 0
        src = torch.where((chan_data > 0) & ~bad, chan_data, 0.0)
        victim_ok = (mask & maskbits.EDGE) == 0
    C = coeffs.shape[0]
    row = np.arange(C) // nx
    same_m = torch.as_tensor(row[:, None] == row[None, :],
                             device=chan_data.device)
    same = torch.where(same_m, coeffs, 0.0)
    cross = torch.where(same_m, 0.0, coeffs)
    corr = (torch.einsum("syx,sv->vyx", src, same)
            + torch.einsum("syx,sv->vyx", src.flip(1), cross))
    if victim_ok is not None:
        corr = torch.where(victim_ok, corr, 0.0)
    return chan_data - corr


def xtalk_correct_mosaic(mosaic, mask, coeffs, ny: int = 2, nx: int = 8):
    """Crosstalk correction directly on the assembled mosaic.

    Same physics as :func:`xtalk_correct`; the cross-row mirrored source
    is ONE vertical flip of the whole mosaic ((row, y) -> (1-row,
    ych-1-y), the mirrored-readout geometry).

    mosaic : (ny*ych, nx*xch) [e-];  mask same shape (or None)
    coeffs : (C, C) source->victim, channel c = row*nx + col
    """
    if ny != 2:
        raise ValueError("xtalk_correct_mosaic assumes the two-row "
                         "mirrored-readout layout (ny=2); use "
                         "xtalk_correct on the channel stack otherwise")
    H, W = mosaic.shape
    ych, xch = H // ny, W // nx
    t = mosaic.reshape(ny, ych, nx, xch)
    if mask is None:
        src = torch.clamp(t, min=0.0)
        victim_ok = None
    else:
        m = mask.reshape(ny, ych, nx, xch)
        bad = (m & (maskbits.BAD | maskbits.COSMIC)) != 0
        src = torch.where((t > 0) & ~bad, t, 0.0)
        victim_ok = (mask & maskbits.EDGE) == 0
    srcf = src.flip(0).flip(1)
    cf = torch.as_tensor(coeffs, dtype=mosaic.dtype,
                         device=mosaic.device).reshape(ny, nx, ny, nx)
    r = torch.arange(ny, device=mosaic.device)
    cfsame = cf[r, :, r, :]                    # (r, cs, cv)
    cfcross = cf[(ny - 1) - r, :, r, :]
    ct = (torch.einsum("rycx,rcv->ryvx", src, cfsame)
          + torch.einsum("rycx,rcv->ryvx", srcf, cfcross))
    corr = ct.reshape(H, W)
    if victim_ok is not None:
        corr = torch.where(victim_ok, corr, 0.0)
    return mosaic - corr
