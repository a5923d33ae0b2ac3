"""Finding charts: annotated N-up/E-left cutouts around a sky position
(port of :mod:`blackbox_tpu.report.finding_chart`).

Rebuild of the reference's standalone finding-chart tool
(/root/reference/finding_chart.py:56-328 CLI, orient_data 501-622):
cut out a box around RA/DEC from a reduced image, remap it through the
CD matrix to the N-up E-left display convention (or to another image's
CD matrix), and render an annotated chart with crosshair and scale bar.
Reads ``.fits[.fz|.gz]`` products over POSIX or gs:// via the storage
layer; the arbitrary-angle resampling is the port's Lanczos3 gather
(:func:`blackbox_tpu_torch.ops.warp.lanczos_resample`) on ``device``,
the card unless the caller asks for another.  Rendering imports
matplotlib, at the call.
"""

from __future__ import annotations

import os

import numpy as np

from blackbox_tpu_torch.astro.wcs import TanWCS
from blackbox_tpu_torch.report.quicklook import zscale

MLBG_TELS = ("ML1", "BG2", "BG3", "BG4")


def orient_north_up(img, wcs: TanWCS):
    """Rotate/flip (by 90° steps) so North is up and East left.

    The cheap path, preserving original pixel values (the reference's
    MLBG_rot90_flip mode, orient_data 565-581); for arbitrary rotation
    angles use :func:`orient_data`.
    """
    rot = wcs.rotation % 360.0
    k = int(round(rot / 90.0)) % 4
    out = np.rot90(img, k)
    # after rotation, East must increase leftwards: check the sign of
    # the RA gradient along +x
    cd = wcs.cd
    det = np.linalg.det(cd)
    flip = det > 0      # astronomical images have det<0 when E-left
    if k % 2 == 1:
        flip = not flip
    if flip:
        out = out[:, ::-1]
    return out


def orient_data(data, wcs: TanWCS, wcs_out: TanWCS | None = None,
                pixscale: float | None = None, rel_tol: float = 1e-3,
                mlbg_rot90_flip: bool = False, tel: str | None = None,
                device="cuda"):
    """Remap square ``data`` from its CD matrix to ``wcs_out``'s.

    Reference ``orient_data`` (finding_chart.py:501-622) at full
    fidelity: without ``wcs_out`` the target is exact North-up
    East-left at ``pixscale`` (default: the data's own scale); matrices
    already equal within ``rel_tol`` skip the remap; MeerLICHT/BlackGEM
    frames can take the value-preserving 90°+flip shortcut; everything
    else goes through an arbitrary-angle affine remap — here a Lanczos3
    resample on ``device`` instead of scipy ``affine_transform``.
    """
    data = np.asarray(data)
    if data.shape[0] != data.shape[1]:
        raise ValueError("orient_data needs a square cutout")
    cd_in = np.asarray(wcs.cd, np.float64)
    if wcs_out is not None:
        cd_out = np.asarray(wcs_out.cd, np.float64)
    else:
        cdelt = (pixscale or wcs.pixscale) / 3600.0
        cd_out = np.array([[-cdelt, 0.0], [0.0, cdelt]])

    if np.all([np.isclose(cd_in[i, j], cd_out[i, j], rtol=rel_tol)
               for i in range(2) for j in range(2)]):
        return data

    if mlbg_rot90_flip and tel in MLBG_TELS:
        out = np.rot90(data, k=-1)
        if tel == "ML1":
            out = np.fliplr(out)
        return out

    # output pixel offsets -> tangent plane via CD_out, back to input
    # pixels via CD_in^-1: [dxi; dyi] = CD_in^-1 @ CD_out @ [dxo; dyo]
    M = np.linalg.inv(cd_in) @ cd_out
    n = data.shape[0]
    c = (n - 1) / 2.0
    d = np.arange(n, dtype=np.float64) - c
    dxo, dyo = np.meshgrid(d, d, indexing="xy")
    xs = (M[0, 0] * dxo + M[0, 1] * dyo + c).astype(np.float32)
    ys = (M[1, 0] * dxo + M[1, 1] * dyo + c).astype(np.float32)

    import torch
    from blackbox_tpu_torch.ops.warp import lanczos_resample
    fill = float(np.median(data))
    out = lanczos_resample(
        torch.as_tensor(np.asarray(data, np.float32), device=device),
        torch.as_tensor(ys, device=device),
        torch.as_tensor(xs, device=device), fill=fill)
    return out.cpu().numpy()


def finding_chart(path: str, image, wcs: TanWCS, ra: float, dec: float,
                  size_arcmin: float = 3.0, title: str | None = None,
                  wcs_out: TanWCS | None = None, cmap: str = "gray_r",
                  info: dict | None = None, device="cuda"):
    """Render an annotated PDF/PNG/JPG finding chart around (ra, dec).

    ``wcs_out`` orients the cutout to another image's CD matrix instead
    of North-up East-left (reference ``header_out``); ``info`` renders
    extra annotation lines (run ID, PI, OB name — the ESO block).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y = wcs.sky2pix(ra, dec)
    npix = int(size_arcmin * 60.0 / wcs.pixscale)
    H, W = image.shape
    half = npix // 2
    x0 = int(np.clip(round(x) - half, 0, max(W - npix, 0)))
    y0 = int(np.clip(round(y) - half, 0, max(H - npix, 0)))
    cut = np.asarray(image[y0:y0 + npix, x0:x0 + npix], np.float32)

    disp = orient_data(cut, wcs, wcs_out=wcs_out, device=device)
    z1, z2 = zscale(cut)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(disp, vmin=z1, vmax=z2, cmap=cmap, origin="lower")
    cy, cx = disp.shape[0] / 2, disp.shape[1] / 2
    gap, ln = 8, 25
    for dx, dy in ((gap, 0), (-gap - ln, 0)):
        ax.plot([cx + dx, cx + dx + (ln if dx > 0 else ln)],
                [cy, cy], "r-", lw=1)
    for dx, dy in ((0, gap), (0, -gap - ln)):
        ax.plot([cx, cx],
                [cy + dy, cy + dy + (ln if dy > 0 else ln)], "r-", lw=1)
    # scale bar: 1 arcmin
    bar = 60.0 / wcs.pixscale
    ax.plot([10, 10 + bar], [10, 10], "k-", lw=2)
    ax.text(10 + bar / 2, 14, "1'", ha="center", fontsize=9)
    orient = "N up, E left" if wcs_out is None else "matched CD"
    ax.text(0.02, 0.98, orient, transform=ax.transAxes,
            va="top", fontsize=9)
    if info:
        lines = [f"{k}: {v}" for k, v in info.items() if v is not None]
        ax.text(0.02, 0.94, "\n".join(lines), transform=ax.transAxes,
                va="top", fontsize=8)
    if title:
        ax.set_title(title, fontsize=10)
    ax.set_xticks([])
    ax.set_yticks([])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=140)
    plt.close(fig)
    return path


def parse_coord(val: str, is_ra: bool) -> float:
    """Decimal degrees, or sexagesimal (hours for RA, degrees for DEC)
    — the reference CLI accepts both (finding_chart.py:100-115)."""
    s = str(val).strip()
    if ":" not in s:
        return float(s)
    sign = -1.0 if s.lstrip().startswith("-") else 1.0
    parts = [float(p) for p in s.lstrip("+-").split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    mag = parts[0] + parts[1] / 60.0 + parts[2] / 3600.0
    return sign * mag * (15.0 if is_ra else 1.0)


def chart_from_product(fits_red: str, ra, dec, out_path: str | None = None,
                       size_arcmin: float = 3.0,
                       target_name: str | None = None,
                       output_format: str = "pdf", cmap: str = "gray_r",
                       info: dict | None = None, device="cuda") -> str:
    """Standalone-CLI core: read a reduced product (.fits/.fz/.gz over
    POSIX or gs://), build the chart next to the cwd."""
    from blackbox_tpu_torch.io.fits import read_fits
    from blackbox_tpu_torch.io.rice import read_rice

    ra_deg = parse_coord(ra, is_ra=True)
    dec_deg = parse_coord(dec, is_ra=False)
    if str(fits_red).endswith(".fz"):
        img, h = read_rice(fits_red)
    else:
        hdus = read_fits(fits_red)
        img, h = next((d, hh) for d, hh in hdus if d is not None
                      and not isinstance(d, dict))
    wcs = TanWCS.from_header(h)
    if out_path is None:
        base = os.path.basename(str(fits_red)).split(".fits")[0]
        tag = (target_name or f"{ra_deg:.4f}{dec_deg:+.4f}").replace(
            " ", "_")
        out_path = f"{base}_{tag}_fc.{output_format}"
    title = target_name or f"RA {ra_deg:.5f}  DEC {dec_deg:+.5f}"
    meta = {"file": os.path.basename(str(fits_red)),
            "DATE-OBS": h.get("DATE-OBS"), "filter": h.get("FILTER"),
            "limmag": h.get("LIMMAG")}
    if info:
        meta.update(info)
    return finding_chart(out_path, img, wcs, ra_deg, dec_deg,
                         size_arcmin=size_arcmin, title=title,
                         cmap=cmap, info=meta, device=device)
