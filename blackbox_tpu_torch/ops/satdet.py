"""Satellite-trail detection via an FFT projection-slice Radon transform
(port of :func:`blackbox_tpu.ops.satdet.detect_trails`).

The binned, background-subtracted, winsorised significance map is
Radon-transformed through the projection-slice theorem — one 2-D FFT, a
bilinear sampling of the spectrum along each angle's central slice, and
batched 1-D inverse FFTs (``torch.fft``).  Trails are peaks of the
band-integrated line statistic over (angle, offset); the peaks are
rasterised back into a widened trail mask.  The tiled segment mode
(:func:`detect_trail_segments`) runs the same detector on overlapping
subframes and merges their lines with a greedy NMS, which runs on the
host over the 80 lines (nine tiles and a seed pass of 8 slots each).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from blackbox_tpu_torch.ops.background import background_mesh, mini2back
from blackbox_tpu_torch.ops.stats import median
from blackbox_tpu_torch.ops.zogy import fast_fft_size
from blackbox_tpu_torch.utils.timing import count


@dataclasses.dataclass(frozen=True)
class SatDetParams:
    bin_factor: int = 16         # binning before the transform
    n_slopes: int = 101          # slopes in [-1, 1] per orientation
    nsigma: float = 8.0          # peak threshold over profile noise
    min_fill: float = 0.2        # min fraction of line inside the frame
    winsor_clip: float = 2.5     # significance winsorisation
    lit_frac: float = 0.5        # min fraction of line pixels lit (>2σ)
    lit_sigma: float = 2.0
    trail_halfwidth: int = 5     # half-width of the rasterised trail mask
    max_trails: int = 8          # static cap on detected trails
    band_widths: tuple = (1, 5, 15)   # offset-band integration widths


def _jmod(x, n: float):
    """``jnp.mod`` for floats: exact fmod, shifted to the divisor's sign."""
    r = torch.fmod(x, n)
    return torch.where((r != 0) & ((r < 0) != (n < 0)), r + n, r)


def _bin2d(img, f: int):
    """f x f average binning."""
    H, W = img.shape
    Hc, Wc = H // f, W // f
    s = img[:Hc * f, :Wc * f].reshape(Hc, f, Wc, f).sum(dim=(1, 3))
    return s / float(f * f)


def _wrap_pad(a, left: int, right: int):
    """Periodic padding of the last axis."""
    parts = [a]
    if left:
        parts.insert(0, a[..., a.shape[-1] - left:])
    if right:
        parts.append(a[..., :right])
    return torch.cat(parts, dim=-1)


def _radon_fft(stack, n_angles: int):
    """Radon transform by the projection-slice theorem.

    stack : (B, Hb, Wb) real maps (zero background assumed)
    Returns (projections (B, n_angles, N), angles (n_angles,), N), where
    projection[b, j, t] integrates stack[b] along the line
    ``x·cosθ_j + y·sinθ_j ≡ t (mod N)`` (corner origin).
    """
    Bn, Hb, Wb = stack.shape
    dev = stack.device
    # 1.5x padding: the projection support spans the image diagonal
    N = int(np.ceil(1.5 * max(Hb, Wb)))
    if N > 512:
        N = fast_fft_size(N)
    if N % 2:
        N += N % 2
    Zp = torch.zeros((Bn, N, N), dtype=torch.complex64, device=dev)
    Zp[:, :Hb, :Wb] = stack
    Fs = torch.fft.fftshift(torch.fft.fft2(Zp), dim=(-2, -1))

    thetas = torch.arange(n_angles, dtype=torch.float32,
                          device=dev) * np.float32(np.pi / n_angles)
    u = (torch.arange(N, device=dev) - N // 2).to(torch.float32)
    kx = u[None, :] * torch.cos(thetas)[:, None] + N // 2       # (A, N)
    ky = u[None, :] * torch.sin(thetas)[:, None] + N // 2
    flat = Fs.reshape(Bn, -1)

    # bilinear interpolation of the complex spectrum, taps mod N
    x0f = torch.floor(kx)
    y0f = torch.floor(ky)
    fx = kx - x0f
    fy = ky - y0f
    x0 = torch.remainder(x0f.to(torch.int64), N)
    y0 = torch.remainder(y0f.to(torch.int64), N)
    x1 = torch.remainder(x0 + 1, N)
    y1 = torch.remainder(y0 + 1, N)

    def tap(iy, ix):
        return flat[:, (iy * N + ix).reshape(-1)].reshape(Bn, *ix.shape)

    S = ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x1)
         + fy * (1 - fx) * tap(y1, x0) + fy * fx * tap(y1, x1))
    proj = torch.fft.ifft(torch.fft.ifftshift(S, dim=-1), dim=-1).real
    return torch.clamp(proj, min=0.0), thetas, N


def _boxsum(a, w: int):
    """Sum of w consecutive offsets, wrap-padded (the Radon offset axis
    is periodic mod N); terms added in order."""
    if w == 1:
        return a
    pa = _wrap_pad(a, w // 2, w - 1 - w // 2)
    n = a.shape[-1]
    out = pa[..., 0:n]
    for i in range(1, w):
        out = out + pa[..., i:i + n]
    return out


def _top_k(vals, k: int):
    """``lax.top_k``: the k largest values, equal values in index order."""
    v, i = torch.sort(vals, descending=True, stable=True)
    return v[:k], i[:k]


def detect_trails(image, mask_excl=None, params: SatDetParams = SatDetParams(),
                  seam_rows: tuple = (), seam_cols: tuple = (),
                  want_lines: bool = False):
    """Detect straight bright trails.

    image     : (H, W) background-subtracted (or raw; the median is removed)
    mask_excl : optional bool — pixels ignored (saturated columns etc.)
    seam_rows/seam_cols : full-resolution coordinates of the channel
        boundaries; axis-aligned detections whose mask would cover a
        seam are instrument artefacts and are vetoed.

    Returns (trail_mask bool (H, W), n_trails, peak_snr (max_trails,)),
    plus, with ``want_lines=True``, a dict of per-slot line parameters
    ``{"theta" (rad), "t" (signed offset, BINNED px, corner origin),
    "snr" (0 = inactive slot)}`` for the segment mode's cross-tile
    dedup (a line is ``(x/f)·cosθ + (y/f)·sinθ = t``).
    """
    p = params
    H, W = image.shape
    dev = image.device
    B = _bin2d(image, p.bin_factor)
    excl = None
    if mask_excl is not None:
        excl = _bin2d(mask_excl.to(torch.float32), p.bin_factor) > 0.5
        B = torch.where(excl, median(B), B)
    # local background: clipped mesh + bicubic upsample on the binned map
    Hb, Wb = B.shape
    box = max(min(min(Hb, Wb) // 4, 16), 4)
    mesh, _ = background_mesh(B[:Hb // box * box, :Wb // box * box],
                              None, box)
    bkg = mini2back(mesh, (Hb, Wb), box)
    med = median(B - bkg)
    mad = median(torch.abs(B - bkg - med)) * 1.4826 + 1e-6
    sig = (B - bkg - med) / mad
    Z = torch.clamp(sig, 0.0, p.winsor_clip)      # winsorised signif. map
    lit = (sig > p.lit_sigma).to(torch.float32)
    if excl is not None:
        Z = torch.where(excl, 0.0, Z)
        lit = torch.where(excl, 0.0, lit)
    # analytic mean/variance of clip(max(z,0), c) for unit-normal noise
    c = p.winsor_clip
    phi0 = 1.0 / math.sqrt(2 * math.pi)
    phic = phi0 * math.exp(-0.5 * c * c)
    tail = 0.5 * math.erfc(c / math.sqrt(2))
    z_mean = (phi0 - phic) + c * tail
    int_z2 = 0.5 * math.erf(c / math.sqrt(2)) - c * phic
    z_var = (int_z2 + c * c * tail) - z_mean ** 2

    n_angles = 2 * p.n_slopes
    ones = torch.ones_like(Z)
    if excl is not None:
        ones = torch.where(excl, 0.0, ones)
    proj, thetas, N = _radon_fft(torch.stack([Z, lit, ones]), n_angles)
    prof, litprof, nhit_raw = proj[0], proj[1], proj[2]

    min_len = p.min_fill * min(Z.shape)
    # band widths up to the physical angle-grid drift; width 1 always
    drift = 1.42 * max(Z.shape) * math.pi / (2 * n_angles)
    widths = (1,) + tuple(w for w in p.band_widths
                          if w != 1 and (w - 1) // 2 <= math.ceil(drift))
    nhit1 = torch.clamp(nhit_raw, min=1.0)
    s_line = (prof / nhit1 - z_mean) * torch.sqrt(nhit1 / z_var)
    snr = torch.zeros_like(prof)
    band_w = torch.ones_like(prof)
    for w in widths:
        pw = _boxsum(prof, w)
        lw = _boxsum(litprof, w)
        nw = torch.clamp(_boxsum(nhit_raw, w), min=1.0)
        line_len = nw / w
        fill_ok = line_len >= min_len
        lit_ok = (lw / torch.clamp(line_len, min=1.0)) >= p.lit_frac
        # score the band against its own flanks (w offsets each side)
        p3 = _boxsum(prof, 3 * w)
        n3 = torch.clamp(_boxsum(nhit_raw, 3 * w), min=1.0)
        flank_n = torch.clamp(n3 - nw, min=1.0)
        flank_mean = torch.clamp((p3 - pw) / flank_n, min=z_mean)
        snr_w = (pw / nw - flank_mean) * torch.sqrt(nw / z_var / w)
        snr_w = torch.where(fill_ok & lit_ok, snr_w, 0.0)
        upd = snr_w > snr
        snr = torch.where(upd, snr_w, snr)
        band_w = torch.where(upd, float(w), band_w)

    # peak picking with non-max suppression; a tiny deterministic ramp
    # breaks plateau ties
    wmax = max(widths)
    tw = max(11, 2 * wmax + 1)
    aw = int(np.clip(
        2 * round(wmax / (min(Z.shape) * np.pi / n_angles)) + 1, 5, 33))
    ramp = torch.arange(snr.numel(), dtype=torch.float32,
                        device=dev).reshape(snr.shape) * np.float32(1e-9)
    snr = torch.where(snr > 0, snr + ramp, snr)
    padded = F.pad(snr, (tw // 2, tw // 2, aw // 2, aw // 2))
    local_max = F.max_pool2d(padded[None, None], (aw, tw), stride=1)[0, 0]
    is_peak = (snr >= local_max) & (snr > p.nsigma)
    vals = torch.where(is_peak, snr, 0.0).reshape(-1)
    top_v, i = _top_k(vals, p.max_trails)
    th = thetas[i // N]
    m0 = (i % N).to(torch.float32)
    w_at = band_w.reshape(-1)[i]

    # refine each band peak on the single-line profile: recentre on its
    # argmax within the winning band, measure the lit extent, and veto
    # thick structures (fully-lit runs wider than ~96 full px)
    thick_lines = max(3, int(np.ceil(96.0 / p.bin_factor)))
    WIN = max(wmax, thick_lines + 1)
    s_pad = _wrap_pad(s_line, WIN, WIN)
    lf_pad = _wrap_pad(litprof / nhit1, WIN, WIN)
    pos = torch.arange(2 * WIN + 1, dtype=torch.float32, device=dev) - WIN
    a_idx = (i // N)[:, None]
    t_idx = (i % N)[:, None] + torch.arange(2 * WIN + 1, device=dev)[None]
    win = s_pad[a_idx, t_idx]                          # (S, 2*WIN+1)
    lfw = lf_pad[a_idx, t_idx]
    inband = torch.abs(pos)[None] <= 0.5 * (w_at[:, None] - 1.0) + 1e-3
    winb = torch.where(inband, win, -torch.inf)
    off = pos[torch.argmax(winb, dim=1)]
    ext = torch.sum((inband & (win > 2.0)).to(torch.float32), dim=1)
    idxw = torch.arange(2 * WIN + 1, device=dev)[None]
    notfull = lfw < 0.8
    above = torch.amin(torch.where(notfull & (idxw >= WIN), idxw,
                                   2 * WIN + 1), dim=1)
    below = torch.amax(torch.where(notfull & (idxw <= WIN), idxw, -1), dim=1)
    thick = (above - below - 1) >= thick_lines
    m0_ref = m0 + off
    ext = torch.clamp(ext - 1.0, min=0.0)
    top_v = torch.where(thick, 0.0, top_v)

    f = float(p.bin_factor)
    hw = p.trail_halfwidth
    # the lit extent quantises down at coarse bins: the physical wander
    # bound floors the mask widening
    wander = 1.42 * max(Z.shape) * np.pi / (2.0 * n_angles)
    hw_k = hw + 0.5 * torch.clamp(ext, min=np.float32(wander)) * f
    cth, sth = torch.cos(th), torch.sin(th)

    if seam_rows or seam_cols:
        # veto axis-aligned peaks whose mask covers a channel seam;
        # within the angle gate the seam's offset varies across the
        # frame by up to `span`, folded into the distance tolerance
        ang_gate = 3.0 * float(np.pi) / n_angles
        hit = torch.zeros_like(top_v, dtype=torch.bool)
        for r in seam_rows:
            t_seam = (0.5 * W / f) * cth + (float(r) / f) * sth
            d = torch.abs(_jmod(t_seam - m0_ref + N / 2.0, float(N))
                          - N / 2.0)
            span = 0.5 * (W / f) * torch.abs(cth)
            hit |= (torch.abs(cth) < ang_gate) & ((d - span) * f <= hw_k + f)
        for cc in seam_cols:
            t_seam = (float(cc) / f) * cth + (0.5 * H / f) * sth
            d = torch.abs(_jmod(t_seam - m0_ref + N / 2.0, float(N))
                          - N / 2.0)
            span = 0.5 * (H / f) * torch.abs(sth)
            hit |= (torch.abs(sth) < ang_gate) & ((d - span) * f <= hw_k + f)
        top_v = torch.where(hit, 0.0, top_v)
    n_trails = torch.sum(top_v > 0, dtype=torch.int32)

    # rasterise only the active slots (read on the host: frames carry
    # 0-2 trails against max_trails slots)
    trail_mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev) / f
    ys = torch.arange(H, dtype=torch.float32, device=dev) / f
    lit = torch.nonzero(top_v > 0).reshape(-1).tolist()
    count("host.reads", 2)          # the nonzero and its list
    for k in lit:
        t = (ys * sth[k])[:, None] + (xs * cth[k])[None, :]
        d = torch.abs(_jmod(t - m0_ref[k] + N / 2.0, float(N)) - N / 2.0)
        trail_mask |= d * f <= hw_k[k]
    if want_lines:
        # canonical signed offset in [-N/2, N/2): offsets from different
        # tile/frame mod bases are comparable
        t_phys = _jmod(m0_ref + N / 2.0, float(N)) - N / 2.0
        return trail_mask, n_trails, top_v, {"theta": th, "t": t_phys,
                                             "snr": top_v}
    return trail_mask, n_trails, top_v


def detect_trail_segments(image, mask_excl=None,
                          params: SatDetParams = SatDetParams(),
                          seam_rows: tuple = (), seam_cols: tuple = (),
                          tiles: int = 2, exclude_lines=None):
    """Partial-trail detection: :func:`detect_trails` on an overlapping
    ``(2·tiles-1) x (2·tiles-1)`` grid of half-stride subframes, with a
    cross-tile NMS so every physical trail counts ONCE.

    The full-frame statistic integrates each candidate line end to end,
    so a streak lighting only ~1/4 of its line fails the lit-fraction
    gate at any amplitude; within a subframe the segment spans most of
    the local line, and a segment-tuned gate (lit fraction 0.3, peak
    threshold floored at 12 sigma) admits it.

    Each tile's detections carry global line parameters (θ, offset); a
    greedy snr-ordered NMS merges lines that coincide within the
    angle-grid resolution and the offset wander.  ``exclude_lines`` (the
    lines of a full-frame ``detect_trails(..., want_lines=True)`` call,
    same binning) seeds the NMS with already-counted trails: their tile
    detections are suppressed and not counted, so ``n_trails_full +
    n_segments`` counts physical trails.  Every slot of
    ``exclude_lines`` seeds, its inactive ones too, as in the JAX
    package (a fault of the reference, matched: those slots sit at
    θ = 0 near the left edge and can suppress a streak there).

    Returns (mask bool (H, W), n_new int32, the new lines' top-k
    significances (max_trails,)).
    """
    params = dataclasses.replace(
        params, lit_frac=min(params.lit_frac, 0.3),
        nsigma=max(params.nsigma, 12.0))
    H, W = image.shape
    th_, tw_ = H // tiles, W // tiles
    # overlapping tile grid (stride = half a tile), the last start
    # pinned to the frame edge so the remainder strip is covered
    y0s = sorted({min(i * th_ // 2, H - th_)
                  for i in range(2 * tiles - 1)} | {H - th_})
    x0s = sorted({min(i * tw_ // 2, W - tw_)
                  for i in range(2 * tiles - 1)} | {W - tw_})
    mask = torch.zeros((H, W), dtype=torch.bool, device=image.device)
    f = float(params.bin_factor)
    thetas_all, ts_all, snrs_all, seeds_all = [], [], [], []
    if exclude_lines is not None:
        thetas_all.append(exclude_lines["theta"])
        ts_all.append(exclude_lines["t"])
        snrs_all.append(exclude_lines["snr"])
        seeds_all.append(torch.ones_like(exclude_lines["snr"],
                                         dtype=torch.bool))
    for y0 in y0s:
        for x0 in x0s:
            sub = image[y0:y0 + th_, x0:x0 + tw_]
            sexcl = (None if mask_excl is None
                     else mask_excl[y0:y0 + th_, x0:x0 + tw_])
            # inclusive lower bound: tile origins land on mid-frame seams
            srows = tuple(r - y0 for r in seam_rows if y0 <= r < y0 + th_)
            scols = tuple(c - x0 for c in seam_cols if x0 <= c < x0 + tw_)
            m, _, _, ln = detect_trails(sub, sexcl, params, seam_rows=srows,
                                        seam_cols=scols, want_lines=True)
            mask[y0:y0 + th_, x0:x0 + tw_] |= m
            # tile-local line -> global frame coordinates
            t_g = ln["t"] + (x0 * torch.cos(ln["theta"])
                             + y0 * torch.sin(ln["theta"])) / f
            thetas_all.append(ln["theta"])
            ts_all.append(t_g)
            snrs_all.append(ln["snr"])
            seeds_all.append(torch.zeros_like(ln["snr"], dtype=torch.bool))

    theta = torch.cat(thetas_all)
    t_off = torch.cat(ts_all)
    snr = torch.cat(snrs_all)
    seed = torch.cat(seeds_all)

    # ---- cross-tile greedy NMS in (θ, global offset) space ----
    n_angles = 2 * params.n_slopes
    dth_grid = np.pi / n_angles
    wmax = max((1,) + tuple(params.band_widths))
    min_tile_b = min(th_, tw_) / f
    # angle tolerance: the in-tile NMS's ghost-fan slack; offset
    # tolerance: the wander over the full frame plus the band slack
    ang_steps = int(np.clip(2 * round(wmax / (min_tile_b * dth_grid))
                            + 1, 5, 33))
    ang_tol = 0.5 * ang_steps * dth_grid + 1e-6
    wander_full = 1.42 * (max(H, W) / f) * np.pi / (2.0 * n_angles)
    t_tol = wander_full + 0.5 * wmax + 2.0

    dth = theta[:, None] - theta[None, :]
    dt = t_off[:, None] - t_off[None, :]
    st = t_off[:, None] + t_off[None, :]
    direct = (torch.abs(dth) <= ang_tol) & (torch.abs(dt) <= t_tol)
    # θ lives on [0, π): a line near 0 registers at θ≈0 in one tile and
    # θ≈π-δ (with negated offset) in another
    flipped = ((torch.abs(torch.abs(dth) - np.pi) <= ang_tol)
               & (torch.abs(st) <= t_tol))
    same = direct | flipped
    active = seed | (snr > 0)
    # seeds first, then by snr: a kept entry suppresses every matching
    # later one
    order = torch.argsort(-(torch.where(seed, np.float32(1e9), 0.0) + snr),
                          stable=True)
    same_o = same[order][:, order].cpu().numpy()
    keep = active[order].cpu().numpy()
    count("host.reads", 2)
    for k in range(len(keep)):
        if keep[k]:
            keep[k + 1:] &= ~same_o[k, k + 1:]
    new = torch.from_numpy(keep).to(snr.device) & ~seed[order]
    n_tot = torch.sum(new, dtype=torch.int32)
    snr_out, _ = _top_k(torch.where(new, snr[order], 0.0), params.max_trails)
    return mask, n_tot, snr_out
