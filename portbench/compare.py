"""The comparison that decides ``correct``: what the timed path made for
a frame against what the plain reference makes from the same inputs.

Each number is a worst case or a share over the frame, in units that do
not depend on the scene's brightness:

- ``mask_px``: pixels whose mask value differs.
- ``image_sigma``: the largest gap of the calibrated (science: the
  background-subtracted) image over the pixels that neither side
  masks, in units of the reference's median background noise.  A pixel
  that one side flags and the other does not (a cosmic-ray hit at the
  threshold) is ``mask_px``'s.
- ``cat_unmatched_pct``: the share of both sides' valid catalog rows,
  in %, that have no row of the other side within ``MATCH_PX``: a
  source moved, lost or added.
- ``cat_sigma``: the largest gap of the aperture or PSF flux of a
  matched source, in units of the reference's error of that flux,
  over the sources farther than ``NEAR_PX`` from a pixel whose mask
  differs.
- ``maps_sigma`` (science): the largest gap of D or Fpsf, in units of
  the reference map's robust spread, over the pixels farther than
  ``NEAR_PX`` from a pixel whose mask differs.
- ``scorr_median_sigma`` (science): the median gap of Scorr, in units of
  its robust spread.  Scorr's largest gap is not held: Scorr divides by
  an astrometric variance from the registration's clipped star matches,
  which a change of one unit in the last place can move, and near a
  saturated star's residual that moves Scorr by several spreads.
- ``trans_sigma`` (science): the largest gap of the PSF flux of a
  transient row with a counterpart at the same peak (within
  ``MATCH_PX``), in units of the reference's error of that flux.  Which
  rows pass the Scorr threshold and the vetting cuts is not held: a row
  at a cut flips, or its peak moves to the next pixel, under the
  smallest change of Scorr.

A NaN on one side only is an infinite gap; NaN on both is none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MATCH_PX = 0.01     # a row's counterpart lies this close, in pixels
NEAR_PX = 16        # the reach of a mask difference into the maps
_SAMPLE = 7         # every 7th pixel for a map's median or spread


def gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise in float64, 0 where both agree or are both
    NaN, inf where only one is NaN."""
    a, b = a.double(), b.double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, d)
    return torch.nan_to_num(d, nan=math.inf)


def _worst(d: torch.Tensor) -> float:
    return float(d.max()) if d.numel() else 0.0


def _spread(m: torch.Tensor) -> float:
    """Robust standard deviation of a map's finite values (1.4826 MAD
    on a fixed subsample)."""
    v = m.reshape(-1)[::_SAMPLE].double()
    v = v[torch.isfinite(v)]
    med = v.median()
    return float(1.4826 * (v - med).abs().median())


def near(differs: torch.Tensor, radius: int) -> torch.Tensor:
    """Pixels within ``radius`` (a square) of a ``True`` of ``differs``."""
    if radius <= 0 or not bool(differs.any()):
        return differs
    k = 2 * radius + 1
    m = differs[None, None].to(torch.float32)
    m = F.max_pool2d(m, (1, k), stride=1, padding=(0, radius))
    m = F.max_pool2d(m, (k, 1), stride=1, padding=(radius, 0))
    return m[0, 0] > 0


def _nearest(ax, ay, bx, by, block: int = 4096):
    """For each a-point, the nearest b-point's index and distance."""
    b = torch.stack([bx, by], 1).double()
    idx, dist = [], []
    for i in range(0, ax.shape[0], block):
        a = torch.stack([ax[i:i + block], ay[i:i + block]], 1).double()
        m = torch.cdist(a, b).min(1)
        idx.append(m.indices)
        dist.append(m.values)
    return torch.cat(idx), torch.nan_to_num(torch.cat(dist), nan=math.inf)


def match(got: dict, want: dict, tol: float = MATCH_PX):
    """(% of both sides' valid rows without a counterpart within
    ``tol``, matched (got, want) row indices)."""
    gv = torch.nonzero(got["valid"]).reshape(-1)
    wv = torch.nonzero(want["valid"]).reshape(-1)
    total = gv.numel() + wv.numel()
    if gv.numel() == 0 or wv.numel() == 0:
        return (100.0 if total else 0.0), gv[:0], wv[:0]
    gx, gy = got["x"][gv], got["y"][gv]
    wx, wy = want["x"][wv], want["y"][wv]
    i, d = _nearest(gx, gy, wx, wy)
    _, d_back = _nearest(wx, wy, gx, gy)
    near_g, near_w = d <= tol, d_back <= tol
    unmatched = int((~near_g).sum()) + int((~near_w).sum())
    return 100.0 * unmatched / total, gv[near_g], wv[i[near_g]]


def _flux_sigma(got: dict, want: dict, gi, wi, away=None,
                fluxes=("flux_ap", "flux_psf")) -> float:
    """The largest gap of the ``fluxes`` of matched rows in the
    reference's errors; ``away`` (H, W) bool keeps the rows whose pixel
    it marks."""
    if away is not None and wi.numel():
        H, W = away.shape
        x = want["x"][wi].round().long().clamp(0, W - 1)
        y = want["y"][wi].round().long().clamp(0, H - 1)
        keep = away[y, x]
        gi, wi = gi[keep], wi[keep]
    worst = 0.0
    for flux in fluxes:
        if flux not in want:
            continue
        err = flux.replace("flux", "fluxerr")
        e = want[err][wi].double().abs().clamp(min=1e-9)
        worst = max(worst, _worst(gap(got[flux][gi], want[flux][wi]) / e))
    return worst


def numbers(got: dict, want: dict) -> dict:
    """Every number this pair of outputs has, by name."""
    sigma = float(want["bkg_std"].reshape(-1)[::_SAMPLE].median())
    differs = got["mask"] != want["mask"]
    unmasked = (got["mask"] == 0) & (want["mask"] == 0)
    away = ~near(differs, NEAR_PX)
    d = gap(got["image"], want["image"])
    out = {"mask_px": int(differs.sum()),
           "image_sigma": _worst(d[unmasked]) / sigma}
    del d
    out["cat_unmatched_pct"], gi, wi = match(got["cat"], want["cat"])
    out["cat_sigma"] = _flux_sigma(got["cat"], want["cat"], gi, wi, away)
    if "D" in want:
        out["maps_sigma"] = max(
            _worst(gap(got[k], want[k])[away]) / _spread(want[k])
            for k in ("D", "Fpsf"))
        g = gap(got["Scorr"], want["Scorr"]).reshape(-1)[::_SAMPLE]
        out["scorr_median_sigma"] = (float(g.median())
                                     / _spread(want["Scorr"]))
        _, gi, wi = match(got["trans_cat"], want["trans_cat"])
        out["trans_sigma"] = _flux_sigma(got["trans_cat"], want["trans_cat"],
                                         gi, wi, fluxes=("flux_psf",))
    return out


def verdict(readings: list, limits: dict) -> tuple:
    """(correct, the worst reading of each limited number): every
    number of every checked frame at or under its limit.  A number
    without a limit, or a limit without its number, is an error."""
    names = set(readings[0]) if readings else set()
    if names != set(limits):
        raise KeyError(f"compared numbers {sorted(names)} and limits "
                       f"{sorted(limits)} differ")
    worst = {k: max(r[k] for r in readings) for k in sorted(limits)}
    ok = bool(readings) and all(worst[k] <= limits[k] for k in limits)
    return ok, worst
