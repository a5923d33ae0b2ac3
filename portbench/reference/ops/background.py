"""Sky-background mesh and full-resolution interpolation (port of
:mod:`blackbox_tpu.ops.background`).

Per-box sigma-clipped median/STD meshes, a 3x3 median filter of the
mesh, and the bicubic (Catmull-Rom) upsample ``Wy @ mesh @ Wx.T`` as
two float32 matmuls (the package pins full float32 at import: the
background must be sub-ADU accurate), or, with ``use_pallas``, through
the K3 kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops.stats import median, nanmedian, sorted_clipped_stats
from portbench.reference.ops.upsample import upsample_mesh


def background_mesh(image, mask, boxsize: int, nsigma: float = 3.0,
                    filtersize: int = 3):
    """Sigma-clipped median/STD background mesh.

    image : (H, W); mask : bool (True = excluded) or None
    Returns (bkg_mini (ny, nx), std_mini (ny, nx)).
    """
    med, std = box_stats(image, mask, boxsize, nsigma)
    med = torch.nan_to_num(med, nan=float(nanmedian(med)))
    std = torch.nan_to_num(std, nan=float(nanmedian(std)))
    if filtersize > 1:
        med = _mesh_median_filter(med, filtersize)
        std = _mesh_median_filter(std, filtersize)
    return med, std


def box_rows(H: int, boxsize: int):
    """(rows, step): the rows the box statistics read.  Large boxes use
    every 8th (or 4th) row, like the JAX package."""
    step = 8 if boxsize >= 128 and boxsize % 8 == 0 else \
        (4 if boxsize >= 64 and boxsize % 4 == 0 else 1)
    return slice(0, H // boxsize * boxsize, step), step


def box_stats(image, mask, boxsize: int, nsigma: float = 3.0):
    """Raw per-box clipped median/STD (NaN where a box is fully masked)."""
    rows, step = box_rows(image.shape[0], boxsize)
    return sampled_box_stats(image[rows],
                             None if mask is None else mask[rows],
                             boxsize, step, nsigma)


def sampled_box_stats(image, mask, boxsize: int, step: int,
                      nsigma: float = 3.0):
    """:func:`box_stats` of the rows it reads (``box_rows``), given."""
    ny, nx = image.shape[0] * step // boxsize, image.shape[1] // boxsize
    bs = boxsize // step

    def tiles_of(a):
        a = a[:, :nx * boxsize]
        return a.reshape(ny, bs, nx, boxsize).transpose(1, 2).reshape(
            ny, nx, -1)

    tiles = tiles_of(image)
    tbad = None if mask is None else tiles_of(mask)
    med, _, std, _ = sorted_clipped_stats(tiles, tbad, sigma=nsigma, iters=3)
    return med, std


def _mesh_median_filter(mesh, k: int):
    p = k // 2
    ny, nx = mesh.shape
    mp = F.pad(mesh[None], (p, p, p, p), mode="replicate")[0]
    views = [mp[dy:dy + ny, dx:dx + nx] for dy in range(k) for dx in range(k)]
    return median(torch.stack(views, 0), axis=0)


@lru_cache(maxsize=16)
def _catmull_rom_matrix(n_out: int, n_mesh: int, boxsize: int) -> np.ndarray:
    """Dense (n_out, n_mesh) Catmull-Rom interpolation matrix (cached,
    read-only: the host loop costs ~0.2 s at 10560 rows).

    Mesh node i sits at pixel centre (i + 0.5) * boxsize - 0.5; edge
    nodes are replicated (clamped) outside the grid.
    """
    W = np.zeros((n_out, n_mesh), np.float32)
    centers0 = 0.5 * boxsize - 0.5
    for y in range(n_out):
        t = (y - centers0) / boxsize
        i0 = int(np.floor(t))
        u = t - i0
        w = np.array([
            0.5 * (-u ** 3 + 2 * u ** 2 - u),
            0.5 * (3 * u ** 3 - 5 * u ** 2 + 2),
            0.5 * (-3 * u ** 3 + 4 * u ** 2 + u),
            0.5 * (u ** 3 - u ** 2),
        ], np.float32)
        for j, wi in zip(range(i0 - 1, i0 + 3), w):
            W[y, min(max(j, 0), n_mesh - 1)] += wi
    W.flags.writeable = False
    return W


def mini2back(mesh, out_shape, boxsize: int, use_pallas: bool = False):
    """Bicubic upsample of a background mesh to full resolution.

    The default is the JAX package's: two float32 matmuls.  With
    ``use_pallas`` it runs :func:`portbench.reference.ops.upsample.
    upsample_mesh`, the port of the TPU kernel K3 (CUDA kernel
    ``csrc/upsample.cu`` on the card); the two differ only in the order
    of the float32 sums.
    """
    H, W = out_shape
    ny, nx = mesh.shape
    Wy = torch.tensor(_catmull_rom_matrix(H, ny, boxsize), device=mesh.device)
    Wx = torch.tensor(_catmull_rom_matrix(W, nx, boxsize), device=mesh.device)
    if use_pallas:
        return upsample_mesh((mesh,), Wy, Wx, (H, W))[0]
    return torch.matmul(torch.matmul(Wy, mesh), Wx.T)
