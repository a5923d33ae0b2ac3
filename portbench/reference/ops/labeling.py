"""Connected components: counting and labeling (port of
:mod:`blackbox_tpu.ops.labeling`).

* :func:`euler_count` — Gray's bit-quad Euler number, which equals the
  8-connected component count for hole-free masks.  The JAX package
  counts quads on bit-packed words (a TPU memory-layout device); here
  the quads are bool planes, and the counts are the same integers.
* :func:`label_components` — bounded min-label propagation, on the card
  through the CUDA kernel ``csrc/labelprop.cu`` (:func:`label_propagate`).
* :func:`count_components` — the components :func:`label_components`
  finds (K1 on the card); :func:`count_components_host` — scipy's count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F




def euler_count(mask: torch.Tensor) -> torch.Tensor:
    """8-connectivity Euler number (= component count for hole-free masks).

    E8 = (Q1 - Q3 - 2*Qd) / 4 over all 2x2 windows of the mask with a
    one-pixel zero border, so border blobs count.  Returns int32.
    """
    m = F.pad(mask.to(torch.uint8), (1, 1, 1, 1))
    a, b = m[:-1, :-1], m[:-1, 1:]
    c, d = m[1:, :-1], m[1:, 1:]
    n = a + b + c + d
    q1 = torch.sum(n == 1)
    q3 = torch.sum(n == 3)
    qd = torch.sum((n == 2) & (a == d))     # two set corners, diagonal
    return torch.div(q1 - q3 - 2 * qd, 4,
                     rounding_mode="floor").to(torch.int32)


def _label_propagate_plain(lab: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of :func:`label_propagate`: ``iters`` separable 3x3
    min steps over the whole frame, background re-gated to BIG."""
    H, W = lab.shape
    big = H * W + 2
    fg = lab < big
    for _ in range(iters):
        p = F.pad(lab, (0, 0, 1, 1), value=big)
        nb = torch.minimum(torch.minimum(p[:-2], p[1:-1]), p[2:])
        p = F.pad(nb, (1, 1), value=big)
        nb = torch.minimum(torch.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
        lab = torch.where(fg, nb, big)
    return lab


def label_propagate(lab: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` synchronous masked 3x3 min-label steps.

    lab : (H, W) int32 — flat index + 1 for foreground, the BIG
        sentinel ``H*W + 2`` for background.
    Returns the propagated labels (background still BIG).  This copy
    takes the plain version on every device.
    """
    return _label_propagate_plain(lab, iters)


def label_components(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Iterative 8-connected labeling by bounded min-label propagation.

    Returns int32 labels: 0 for background, else the flat index + 1 of
    the smallest pixel the label reached within ``iters`` steps.
    """
    H, W = mask.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=mask.device).reshape(H, W)
    lab = torch.where(mask, idx, H * W + 2)
    lab = label_propagate(lab, iters)
    return torch.where(mask, lab, 0)


def count_components(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """8-connected component count via labeling: the pixels that hold
    their own label (exact when ``iters`` steps reach across every
    component)."""
    lab = label_components(mask, iters=iters)
    H, W = mask.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=mask.device).reshape(H, W)
    return torch.sum((lab == idx) & mask)


def count_components_host(mask) -> int:
    """Exact 8-connected component count on the host (scipy)."""
    import numpy as np
    from scipy import ndimage
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    _, n = ndimage.label(np.asarray(mask), structure=np.ones((3, 3), bool))
    return int(n)
