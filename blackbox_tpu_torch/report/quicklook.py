"""Quicklook JPEGs and transient thumbnails.

Rebuild of the reference's jpg/thumbnail makers
(reference blackbox.py:862-928 zscale jpg quicklooks;
2674-2826 per-transient RED/REF/D/SCORR png grids).
"""

from __future__ import annotations

import os

import numpy as np


def zscale(img, contrast: float = 0.25, nsample: int = 10000):
    """IRAF-style zscale display limits (used by the reference's jpgs)."""
    a = np.asarray(img, np.float32).ravel()
    a = a[np.isfinite(a)]
    if a.size == 0:
        return 0.0, 1.0
    if a.size > nsample:
        a = a[:: a.size // nsample]
    a = np.sort(a)
    n = a.size
    med = a[n // 2]
    x = np.arange(n) - n / 2.0
    # iterative line fit with k-sigma rejection
    keep = np.ones(n, bool)
    slope = 0.0
    for _ in range(3):
        if keep.sum() < 5:
            break
        p = np.polyfit(x[keep], a[keep], 1)
        slope = p[0]
        resid = a - np.polyval(p, x)
        s = resid[keep].std()
        keep = np.abs(resid) < 2.5 * max(s, 1e-9)
    z1 = med + slope / contrast * (-n / 2.0)
    z2 = med + slope / contrast * (n / 2.0)
    return float(max(z1, a[0])), float(min(z2, a[-1]))


def save_jpeg(path: str, img, title: str | None = None,
              quality: int = 85):
    """Write a zscaled grayscale JPEG quicklook of an image."""
    from PIL import Image, ImageDraw

    z1, z2 = zscale(img)
    a = np.clip((np.asarray(img, np.float32) - z1)
                / max(z2 - z1, 1e-9), 0, 1)
    a8 = (a[::-1] * 255).astype(np.uint8)      # N-up display convention
    im = Image.fromarray(a8, "L")
    if title:
        d = ImageDraw.Draw(im)
        d.text((4, 4), title, fill=255)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path, quality=quality)
    return path


def cutout(img, x: float, y: float, size: int):
    """Clamped square cutout around (x, y)."""
    H, W = img.shape
    half = size // 2
    x0 = int(np.clip(round(x) - half, 0, max(W - size, 0)))
    y0 = int(np.clip(round(y) - half, 0, max(H - size, 0)))
    return np.asarray(img[y0:y0 + size, x0:x0 + size])


def save_thumbnails(path: str, panels: dict, x: float, y: float,
                    size: int = 100):
    """One PNG row of cutouts (RED | REF | D | SCORR) around a transient
    (reference save_png_thumbnails, blackbox.py:2674-2826)."""
    from PIL import Image

    tiles = []
    for name, img in panels.items():
        c = cutout(img, x, y, size)
        z1, z2 = zscale(c) if c.std() > 0 else (c.min(), c.min() + 1)
        a = np.clip((c - z1) / max(z2 - z1, 1e-9), 0, 1)
        pad = np.zeros((size, size), np.float32)
        pad[:a.shape[0], :a.shape[1]] = a
        tiles.append((pad[::-1] * 255).astype(np.uint8))
    row = np.concatenate(tiles, axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(row, "L").save(path)
    return path


def transient_thumbnail_grid(path: str, red, ref, D, scorr, xs, ys,
                             size: int = 64, max_rows: int = 100):
    """Stacked thumbnail rows for the night's transients."""
    from PIL import Image

    rows = []
    for x, y in list(zip(xs, ys))[:max_rows]:
        tiles = []
        for img in (red, ref, D, scorr):
            c = cutout(img, x, y, size)
            z1, z2 = zscale(c) if np.std(c) > 0 else (0, 1)
            a = np.clip((c - z1) / max(z2 - z1, 1e-9), 0, 1)
            pad = np.zeros((size, size), np.float32)
            pad[:a.shape[0], :a.shape[1]] = a
            tiles.append((pad[::-1] * 255).astype(np.uint8))
        rows.append(np.concatenate(tiles, axis=1))
    if not rows:
        return None
    grid = np.concatenate(rows, axis=0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid, "L").save(path)
    return path


def save_rgb(path: str, red, green, blue, quality: int = 88):
    """Colour figure from three filter co-adds (reference prep_colfig,
    reference buildref.py:906-978): per-channel zscale stretch."""
    from PIL import Image

    chans = []
    for img in (red, green, blue):
        z1, z2 = zscale(img)
        a = np.clip((np.asarray(img, np.float32) - z1)
                    / max(z2 - z1, 1e-9), 0, 1)
        chans.append((a[::-1] * 255).astype(np.uint8))
    rgb = np.stack(chans, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(rgb, "RGB").save(path, quality=quality)
    return path
