"""Masked and sigma-clipped statistics (port of :mod:`blackbox_tpu.ops.stats`).

Clipping runs a fixed number of iterations, like the JAX package
(iterations past the fixed point are no-ops).  Every function takes an
optional boolean ``mask`` (True = excluded) and maps empty selections
to NaN.
"""

from __future__ import annotations

import torch

_NAN = float("nan")


def _expand(t: torch.Tensor, axis):
    return t if axis is None else t.unsqueeze(axis)


def _sum(x: torch.Tensor, axis):
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis)


def median(x: torch.Tensor, axis=None) -> torch.Tensor:
    """``jnp.median``: mean of the two middle values; NaN if any is NaN."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    n = x.shape[axis]
    xs = torch.sort(x, dim=axis).values
    lo = xs.select(axis, (n - 1) // 2)
    hi = xs.select(axis, n // 2)
    med = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(dim=axis), _NAN, med)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` over all elements (NaN only if all are NaN)."""
    flat = x.reshape(-1)
    return masked_median(flat, torch.isnan(flat), axis=0)


def nanmean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmean`` over all elements (NaN if all are NaN)."""
    flat = x.reshape(-1)
    ok = ~torch.isnan(flat)
    return torch.sum(torch.where(ok, flat, 0.0)) / torch.sum(ok)


def nanstd(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanstd`` (ddof 0) over all elements (NaN if all are NaN)."""
    flat = x.reshape(-1)
    ok = ~torch.isnan(flat)
    m = nanmean(flat)
    return torch.sqrt(torch.sum(torch.where(ok, (flat - m) ** 2, 0.0))
                      / torch.sum(ok))


def masked_mean_std(x, mask=None, axis=None, ddof: int = 0):
    """Mean and std of unmasked elements (mask True = excluded)."""
    if mask is None:
        n = float(x.numel() if axis is None else x.shape[axis])
        m = torch.mean(x) if axis is None else torch.mean(x, dim=axis)
        d = (x - _expand(m, axis)) ** 2
        v = torch.mean(d) if axis is None else torch.mean(d, dim=axis)
        return m, torch.sqrt(v * n / max(n - ddof, 1.0))
    keep = ~mask
    n = _sum(keep, axis).to(x.dtype)
    s = _sum(torch.where(keep, x, 0.0), axis)
    mean = s / torch.clamp(n, min=1)
    var = _sum(torch.where(keep, (x - _expand(mean, axis)) ** 2, 0.0), axis)
    std = torch.sqrt(var / torch.clamp(n - ddof, min=1))
    return (torch.where(n < 1, _NAN, mean), torch.where(n <= ddof, _NAN, std))


def masked_median(x, mask=None, axis=-1):
    """Median of unmasked elements along ``axis`` (True = excluded)."""
    if mask is None:
        return median(x, axis=axis)
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, big, x), dim=axis).values
    n = torch.sum(~mask, dim=axis)
    i_lo = torch.clamp(n - 1, min=0) // 2
    i_hi = n // 2
    lo_v = torch.gather(xs, axis, i_lo.unsqueeze(axis)).squeeze(axis)
    hi_v = torch.gather(xs, axis, i_hi.unsqueeze(axis)).squeeze(axis)
    med = 0.5 * (lo_v + hi_v)
    return torch.where(n < 1, _NAN, med)


def sigma_clip(x, mask=None, axis=None, sigma: float = 3.0,
               iters: int = 5):
    """Fixed-iteration sigma clipping.  Returns the final exclusion mask.

    Center per iteration is the mean of the kept values, scale their
    std (ddof=0); values outside ``center -/+ sigma * std`` are
    excluded (the JAX package's ``cenfunc="mean"``, the only centre the
    reduction uses).
    """
    if mask is None:
        mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    m = mask | ~torch.isfinite(x)
    for _ in range(iters):
        center, std = masked_mean_std(x, m, axis=axis)
        center = _expand(center, axis)
        std = _expand(std, axis)
        new_m = m | (x < center - sigma * std) | (x > center + sigma * std)
        # keep everything masked if stats were NaN (all-masked slice)
        m = torch.where(torch.isnan(std) | (std == 0), m, new_m)
    return m


def sorted_clipped_stats(x, mask=None, sigma: float = 3.0, iters: int = 3):
    """(median, mean, std, n) after sigma clipping, from ONE sort.

    On data sorted along the last axis the kept set is a contiguous
    index interval, so clipping reduces to interval bookkeeping: medians
    are gathers, means/stds come from prefix sums, new bounds are rank
    counts.  Same statistics as clipping with center = median, ddof=0.
    """
    inf = float("inf")
    bad = ~torch.isfinite(x) if mask is None else (mask | ~torch.isfinite(x))
    xs = torch.sort(torch.where(bad, inf, x), dim=-1).values
    n0 = torch.sum(~bad, dim=-1)

    def _take_from(a, idx):
        # negative indices wrap, as in jnp.take_along_axis (an empty
        # interval asks for index -1; its statistics end up NaN)
        idx = torch.remainder(idx, a.shape[-1])
        return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)

    def _take(idx):
        v = _take_from(xs, idx)
        return torch.where(torch.isfinite(v), v, 0.0)

    # a per-slice pivot removes the common offset so the f32 sum of
    # squares does not cancel
    pivot = _take(torch.clamp(n0 - 1, min=0) // 2)
    finite = torch.isfinite(xs)
    xz = torch.where(finite, xs - pivot.unsqueeze(-1), 0.0)
    xc = torch.where(finite, xs - pivot.unsqueeze(-1), inf)
    zero = torch.zeros(xz.shape[:-1] + (1,), dtype=xz.dtype,
                       device=xz.device)
    S1 = torch.cat([zero, torch.cumsum(xz, dim=-1)], dim=-1)
    S2 = torch.cat([zero, torch.cumsum(xz * xz, dim=-1)], dim=-1)

    def _interval_stats(lo, hi):
        k = torch.clamp(hi - lo, min=1).to(torch.float32)
        med = 0.5 * (_take(lo + (hi - lo - 1) // 2)
                     + _take(lo + (hi - lo) // 2))
        s1 = _take_from(S1, hi) - _take_from(S1, lo)
        s2 = _take_from(S2, hi) - _take_from(S2, lo)
        mean = s1 / k
        var = torch.clamp(s2 / k - mean * mean, min=0.0)
        return med, mean + pivot, torch.sqrt(var)

    lo = torch.zeros(n0.shape, dtype=torch.int64, device=x.device)
    hi = n0.to(torch.int64)
    for _ in range(iters):
        med, _, std = _interval_stats(lo, hi)
        vlo = (med - pivot) - sigma * std
        vhi = (med - pivot) + sigma * std
        lo2 = torch.sum(xc < vlo.unsqueeze(-1), dim=-1)
        hi2 = torch.sum(xc <= vhi.unsqueeze(-1), dim=-1)
        keep = (std == 0) | (hi - lo < 1)
        lo, hi = (torch.where(keep, lo, torch.maximum(lo2, lo)),
                  torch.where(keep, hi, torch.minimum(hi2, hi)))
    med, mean, std = _interval_stats(lo, hi)
    n = hi - lo
    empty = n < 1
    return (torch.where(empty, _NAN, med), torch.where(empty, _NAN, mean),
            torch.where(empty, _NAN, std), n.to(torch.int32))


def sigma_clipped_mean_std(x, mask=None, axis=None, sigma: float = 3.0,
                           iters: int = 5):
    """astropy ``sigma_clipped_stats``-style (mean, std) after clipping."""
    m = sigma_clip(x, mask=mask, axis=axis, sigma=sigma, iters=iters)
    return masked_mean_std(x, m, axis=axis)
