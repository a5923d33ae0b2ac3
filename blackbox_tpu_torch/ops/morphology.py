"""Binary morphology: hole fill and the saturation close/fill (port of
:mod:`blackbox_tpu.ops.morphology`).

The JAX package runs these on bit-packed words, a TPU memory-layout
device; here they run on bool planes with the same operations, so every
pixel (and every count made from them) is the same.  All functions take
``(..., H, W)`` bool tensors and work over any leading batch dims.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, d: int, dim: int, fill: bool) -> torch.Tensor:
    """new[p] = old[p - d] along ``dim``; pixels shifted in are ``fill``."""
    if d == 0:
        return x
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = min(abs(d), n)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if d > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - pad_shape[dim])], dim)
    return torch.cat([x.narrow(dim, pad_shape[dim], n - pad_shape[dim]),
                      pad], dim)


def _dilate3(m: torch.Tensor) -> torch.Tensor:
    """3x3 full-structure dilation, outside the frame False."""
    v = m | _shift(m, 1, -2, False) | _shift(m, -1, -2, False)
    return v | _shift(v, 1, -1, False) | _shift(v, -1, -1, False)


def _erode3(m: torch.Tensor) -> torch.Tensor:
    """3x3 erosion, outside the frame True."""
    v = m & _shift(m, 1, -2, True) & _shift(m, -1, -2, True)
    return v & _shift(v, 1, -1, True) & _shift(v, -1, -1, True)


def fill_holes(m: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Fill background regions not connected to the frame border.

    The complement is flooded from the border by ``iterations`` rounds
    of four directional sweeps (down, up, right, left); each sweep is a
    log-doubling segmented scan, R <- R | (shift(R, d) & O_run),
    O_run <- O_run & shift(O_run, d), d doubling.
    """
    H, W = m.shape[-2], m.shape[-1]
    O = ~m
    border = torch.zeros((H, W), dtype=torch.bool, device=m.device)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    R = O & border

    def sweep(R, dim: int, sgn: int):
        Rs = R & O
        Orun = O
        d = 1
        lim = H if dim == -2 else W
        while d < lim:
            Rs = Rs | (_shift(Rs, sgn * d, dim, False) & Orun)
            Orun = Orun & _shift(Orun, sgn * d, dim, False)
            d *= 2
        return Rs

    for _ in range(max(iterations, 1)):
        R = sweep(R, -2, 1)
        R = sweep(R, -2, -1)
        R = sweep(R, -1, 1)
        R = sweep(R, -1, -1)
    return m | (O & ~R)


def satcon_close_fill(mask_sat: torch.Tensor, fill_iters: int = 1):
    """Saturation morphology: returns ``(satcon_add, filled)`` with

        dil        = 3x3 dilation of mask_sat
        satcon_add = dil & ~mask_sat
        filled     = fill_holes(closing(dil), fill_iters)

    (``mask_sat | satcon_add`` is exactly the dilation, so the closing
    starts from it).
    """
    dil = _dilate3(mask_sat)
    closed = _erode3(_dilate3(dil))
    return dil & ~mask_sat, fill_holes(closed, fill_iters)
