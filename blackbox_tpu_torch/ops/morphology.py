"""Binary morphology: dilation, erosion, closing, hole fill and the
saturation close/fill (port of :mod:`blackbox_tpu.ops.morphology`).

The JAX package runs these on bit-packed words, a TPU memory-layout
device; here they run on bool planes with the same operations, so every
pixel (and every count made from them) is the same.  The hole fill on
the card is the CUDA kernel ``csrc/fillholes.cu`` (K8), which packs the
planes into words itself and runs each sweep as a carry scan.  All
functions take ``(..., H, W)`` bool tensors and work over any leading
batch dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blackbox_tpu_torch import kernels
from blackbox_tpu_torch.utils.timing import span


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


def _pool(m: torch.Tensor, size: int) -> torch.Tensor:
    """Max of each ``size`` x ``size`` window of ``m`` padded with
    ``size // 2`` False pixels on every side (the JAX package's window
    reduction, so an even size grows the plane by one)."""
    H, W = m.shape[-2], m.shape[-1]
    p = size // 2
    x = F.pad(m.reshape(-1, 1, H, W).to(torch.float32), (p, p, p, p))
    out = F.max_pool2d(x, size, stride=1) > 0.5
    return out.reshape(m.shape[:-2] + out.shape[-2:])


def binary_dilation(m: torch.Tensor, iterations: int = 1,
                    size: int = 3) -> torch.Tensor:
    """Dilation with a full ``size`` x ``size`` structure, ``iterations``
    times (scipy's border: outside the frame False)."""
    for _ in range(iterations):
        m = _dilate3(m) if size == 3 else _pool(m, size)
    return m


def binary_erosion(m: torch.Tensor, iterations: int = 1,
                   size: int = 3) -> torch.Tensor:
    """Erosion with a full structure, ``iterations`` times (outside the
    frame True, scipy's ``border_value=1``)."""
    for _ in range(iterations):
        m = _erode3(m) if size == 3 else ~_pool(~m, size)
    return m


def binary_closing(m: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Dilation then erosion, each with its own border rule."""
    return binary_erosion(binary_dilation(m, size=size), size=size)


def fill_holes(m: torch.Tensor, iterations: int = 3,
               size: int = 3) -> torch.Tensor:
    """Fill background regions not connected to the frame border.

    The complement is flooded from the border by ``iterations`` rounds
    of four directional sweeps (down, up, right, left); each sweep is a
    log-doubling segmented scan, R <- R | (shift(R, d) & O_run),
    O_run <- O_run & shift(O_run, d), d doubling.  ``size`` is the JAX
    package's parameter, which it does not use either.  CPU tensors take
    that plain version; CUDA tensors run the kernel
    (``csrc/fillholes.cu``), one launch a call.
    """
    H, W = m.shape[-2], m.shape[-1]
    plain = m.device.type == "cpu"
    with span("fill_holes", planes=m.numel() // max(H * W, 1), H=H, W=W,
              route="plain" if plain else "kernel"):
        if plain:
            return _fill_holes(m, iterations)
        return _fill_holes_cuda(m, iterations)


def _fill_holes_cuda(m: torch.Tensor, iterations: int) -> torch.Tensor:
    if m.dtype != torch.bool or m.dim() < 2:
        raise ValueError("fill_holes: (..., H, W) bool mask expected")
    m = m.contiguous()
    H, W = m.shape[-2], m.shape[-1]
    if m.numel() == 0:
        return m.clone()
    planes = m.numel() // (H * W)
    words = planes * H * -(-W // 32)          # 32 pixels a word
    words = -(-words // 32) * 32
    # the packed complement and reach and the segments' carries, a
    # plane of words each
    scratch = torch.empty(4 * words, dtype=torch.int32, device=m.device)
    out = torch.empty_like(m)
    kernels.launch("fill_holes", (m,), m.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), planes, H, W, max(iterations, 1))
    return out


def _fill_holes(m: torch.Tensor, iterations: int) -> torch.Tensor:
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
