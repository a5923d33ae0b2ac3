"""Remap of the reference onto the new frame's grid by two passes of
shifted adds (port of the shift2pass path of :mod:`blackbox_tpu.ops.warp`).

A survey remap deviates from the identity by a few pixels, so the
separable Lanczos-3 resample factors into integer SHIFTS with
spatially varying weights:

    pass 1 (rows):  V(y, x) = sum_s  src[y+s, x] * Ly(dys(y,x) - s)
    pass 2 (cols):  out(y, x) = sum_s V[y, x+s] * Lx(dxs(y,x) - s)

with s over the static integer ranges of :func:`grid_shift_ranges`;
every term is one streaming elementwise pass.  The coordinate planes
come from coarse nodes: by two small matmuls (:func:`upsample_grid`)
or by repeat + lerp at a static node spacing (:func:`upsample_lerp`).
:func:`grid_shift_ranges` and :func:`grid_row_margin` are host numpy
copies of the JAX package's (``tests/test_torch_import.py`` holds them
equal).  The gather resamplers and the WCS grid builders are not in
this port yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def upsample_grid(coarse, Wy, Wx):
    """Bilinear upsample of a coarse coordinate grid: ``Wy @ c @ Wx.T``."""
    return torch.matmul(torch.matmul(Wy, coarse), Wx.T)


def upsample_lerp(c, step: int, H: int, W: int):
    """Bilinear coarse-grid upsample as repeat + lerp (no matmuls)."""
    c = torch.as_tensor(c, dtype=torch.float32)
    ny, nx = c.shape
    t = torch.arange(step, dtype=torch.float32, device=c.device) / step
    ty = t.repeat(ny - 1)[:H, None]
    rows = (torch.repeat_interleave(c[:-1], step, dim=0)[:H]
            + ty * torch.repeat_interleave(c[1:] - c[:-1], step, dim=0)[:H])
    tx = t.repeat(nx - 1)[:W][None, :]
    return (torch.repeat_interleave(rows[:, :-1], step, dim=1)[:, :W]
            + tx * torch.repeat_interleave(rows[:, 1:] - rows[:, :-1], step,
                                           dim=1)[:, :W])


def grid_shift_ranges(sy, sx, step: int = 32, a: int = 3,
                      blocks: int = 1):
    """Integer shift ranges of a coarse grid: the static bounds
    :func:`warp_shift2pass` fans its shifted adds over.  Host-side
    (numpy coarse nodes).

    blocks=1 returns ((ry0, ry1), (rx0, rx1)).  blocks=B returns
    (ry_list, rx_list) with B per-strip ranges: the row shift varies
    mostly along x and the column shift along y, so a strip needs only
    its LOCAL range."""
    dy = np.asarray(sy, np.float64) - np.arange(
        sy.shape[0], dtype=np.float64)[:, None] * step
    dx = np.asarray(sx, np.float64) - np.arange(
        sx.shape[1], dtype=np.float64)[None, :] * step

    def rng(d):
        return (int(np.floor(d.min())) - a + 1,
                int(np.floor(d.max())) + a)

    if blocks <= 1:
        return rng(dy), rng(dx)
    # dy ranges per COLUMN strip (node axis 1), dx per ROW strip
    ny, nx = dy.shape
    # +1 node of overlap: a strip boundary falls inside a coarse cell
    ry = [rng(dy[:, max(0, (b * nx) // blocks - 1):
              ((b + 1) * nx) // blocks + 1]) for b in range(blocks)]
    rx = [rng(dx[max(0, (b * ny) // blocks - 1):
              ((b + 1) * ny) // blocks + 1, :]) for b in range(blocks)]
    return ry, rx


def _edge_pad(im, axis: int, before: int, after: int):
    """``jnp.pad(mode="edge")`` along one axis of a 2-D tensor."""
    if before == 0 and after == 0:
        return im
    n = im.shape[axis]
    idx = torch.clamp(torch.arange(-before, n + after, device=im.device),
                      0, n - 1)
    return torch.index_select(im, axis, idx)


def warp_shift2pass(srcs, modes, fills, grid, ranges, a: int = 3):
    """Smooth-warp resample as two passes of variable-weight shifted
    adds (see the module note).

    srcs   : tuple of (H, W) sources sharing one mapping
    modes  : per source "lanczos" | "nearest"
    fills  : per source out-of-frame fill value
    grid   : (sy, sx, Wy, Wx) coarse nodes + upsample matrices,
             (sy, sx, step) coarse nodes at a static spacing, or
             (ys, xs) full coordinate planes
    ranges : ((ry0, ry1), (rx0, rx1)) inclusive integer shift bounds,
             or per-strip lists of them (:func:`grid_shift_ranges`)

    The vertical weights are evaluated at the pixel's own column, a
    second-order approximation (~0.01 px for a 3-arcmin rotation at
    10.5k²).  Edge taps replicate the border; out-of-frame samples take
    the fill, with the frame bounds taken from the SOURCE's shape.
    """
    dev = srcs[0].device
    if len(grid) == 4:
        sy, sx, Wy, Wx = grid
        ys = upsample_grid(torch.as_tensor(sy, dtype=torch.float32,
                                           device=dev), Wy, Wx)
        xs = upsample_grid(torch.as_tensor(sx, dtype=torch.float32,
                                           device=dev), Wy, Wx)
    elif len(grid) == 3:
        sy, sx, step = grid
        H, W = srcs[0].shape
        ys = upsample_lerp(torch.as_tensor(sy, device=dev), int(step), H, W)
        xs = upsample_lerp(torch.as_tensor(sx, device=dev), int(step), H, W)
    else:
        ys, xs = grid
    H, W = ys.shape
    ry, rx = ranges
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    dys = ys - yy
    dxs = xs - xx

    def pass_strip(imgs, d, r0, r1, axis, mode):
        # the OUTPUT length along ``axis`` is the grid's, which may be
        # shorter than the source (a slab feeding a block)
        n = d.shape[axis]
        n_src = imgs[0].shape[axis]
        ps = [_edge_pad(im, axis, max(-r0, 0), max(r1 + n - n_src, 0))
              for im in imgs]
        off = max(-r0, 0)

        def sl(p, s):
            i0 = off + s
            return p[i0:i0 + n, :] if axis == 0 else p[:, i0:i0 + n]

        def zero_like(im):
            shape = (n, im.shape[1]) if axis == 0 else (im.shape[0], n)
            return torch.zeros(shape, dtype=im.dtype, device=im.device)

        if mode == "nearest":
            # rounding needs no tap margin: shrink to the round range
            n0, n1 = r0 + a - 1, r1 - a + 1
            si = torch.clamp(torch.round(d).to(torch.int32), n0, n1)
            outs = [zero_like(im) for im in imgs]
            for s in range(n0, n1 + 1):
                m = si == s
                outs = [torch.where(m, sl(p, s), o)
                        for p, o in zip(ps, outs)]
            return outs
        # Lanczos taps by the angle-addition identity (3 transcendentals
        # per pass instead of 2 per shift), after a static integer
        # re-centring of d and s by the range centre: exact (d - s is
        # unchanged) and it bounds the sin argument by half the range
        c0 = (r0 + r1) // 2
        d0 = d - c0
        pid = math.pi * d0
        s_pi = torch.sin(pid)
        s_pa = torch.sin(pid / a)
        c_pa = torch.cos(pid / a)
        accs = [zero_like(im) for im in imgs]
        norm = torch.zeros(d.shape, dtype=torch.float32, device=d.device)
        for s in range(r0, r1 + 1):
            ds = d0 - (s - c0)
            sgn = float((-1.0) ** ((s - c0) % 2))
            cs = float(math.cos(math.pi * (s - c0) / a))
            ss = float(math.sin(math.pi * (s - c0) / a))
            num = (a * sgn) * s_pi * (s_pa * cs - c_pa * ss)
            pid2 = (math.pi * ds) ** 2
            w = torch.where(torch.abs(ds) < 1e-7, 1.0,
                            num / torch.clamp(pid2, min=1e-7))
            w = torch.where(torch.abs(ds) < a, w, 0.0)
            norm = norm + w
            accs = [acc + w * sl(p, s) for p, acc in zip(ps, accs)]
        norm = torch.where(norm == 0, 1.0, norm)
        return [acc / norm for acc in accs]

    def pass_axis(imgs, d, r, axis, mode):
        if isinstance(r[0], (int, np.integer)):
            return pass_strip(imgs, d, int(r[0]), int(r[1]), axis, mode)
        # per-strip static ranges: the vertical pass strips along x,
        # the horizontal pass along y
        B = len(r)
        n_perp = imgs[0].shape[1 - axis]
        blocks = []
        for b, (r0, r1) in enumerate(r):
            c0, c1 = (b * n_perp) // B, ((b + 1) * n_perp) // B
            if axis == 0:
                blocks.append(pass_strip(
                    [im[:, c0:c1] for im in imgs], d[:, c0:c1],
                    int(r0), int(r1), axis, mode))
            else:
                blocks.append(pass_strip(
                    [im[c0:c1, :] for im in imgs], d[c0:c1, :],
                    int(r0), int(r1), axis, mode))
        return [torch.cat([blk[i] for blk in blocks], dim=1 - axis)
                for i in range(len(imgs))]

    unknown = set(modes) - {"lanczos", "nearest"}
    if unknown:
        raise ValueError(f"unknown resample mode(s) {unknown}")

    def _widen(x):
        # narrow integer planes (the uint8 mask) ride as float32, which
        # holds their values exactly
        if not x.is_floating_point() and x.element_size() <= 2:
            return x.to(torch.float32)
        return x

    results = {}
    for mode in ("lanczos", "nearest"):
        group = [i for i, m in enumerate(modes) if m == mode]
        if not group:
            continue
        v = pass_axis([_widen(srcs[i]) for i in group], dys, ry, 0, mode)
        o = pass_axis(v, dxs, rx, 1, mode)
        # fill bounds come from the SOURCE's shape, not the grid's: they
        # differ when a slab taller than the output block feeds the warp
        Hs, Ws = srcs[group[0]].shape
        if mode == "lanczos":
            inb = (ys >= 0) & (ys <= Hs - 1) & (xs >= 0) & (xs <= Ws - 1)
        else:
            inb = ((ys >= -0.5) & (ys <= Hs - 0.5) & (xs >= -0.5)
                   & (xs <= Ws - 0.5))
        for i, oi in zip(group, o):
            dt = srcs[i].dtype
            fill = torch.as_tensor(fills[i], device=dev).to(dt)
            results[i] = torch.where(inb, oi.to(dt), fill)
    return tuple(results[i] for i in range(len(srcs)))


def grid_row_margin(sy, step: int = 32, a: int = 3) -> int:
    """Slab margin from coarse row nodes: max |source row - destination
    row| over the grid + tap radius."""
    dest = np.arange(sy.shape[0], dtype=np.float64)[:, None] * step
    return int(np.ceil(np.max(np.abs(np.asarray(sy, np.float64)
                                     - dest)))) + a + 2
