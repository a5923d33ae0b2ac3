"""L.A.Cosmic cosmic-ray rejection (port of
:mod:`blackbox_tpu.ops.cosmics`).

Laplacian edge detection on the 2x-subsampled image, normalised by a
Poisson+readnoise model, compared against the fine structure of the
image to separate sharp cosmic rays from stars, grown to neighbours,
and cleaned with a masked 5x5 median (van Dokkum 2001, PASP 113, 1420).

The variants follow the JAX package's ``LACosmicParams``, in its order:

- ``use_pallas``: the fused iteration of the TPU kernel K7, ported as
  :func:`blackbox_tpu_torch.ops.lacosmic_fused.lacosmic_fused` (CUDA
  kernel ``csrc/lacosmic.cu``).  It computes a different function from
  the dense round (it re-cleans every flagged pixel each iteration).
- ``coords``: the dense rounds on a column block (the sharded path).
- ``sepmed``: separable medians for detection, dense masked clean.
- ``windowed`` (the default, with a scalar read noise): the JAX
  package's windowed rounds (:func:`_windowed_pass`).  Round 1 detects
  over the whole frame (the four k x k medians on the card through the
  CUDA kernel ``csrc/medians.cu``, K2), or with ``prescreen`` only
  around the cells of a cheap seed superset (:func:`_prescreen_seeds`);
  the clean and rounds 2..niter then run only in windows around the
  64-px cells that hold a cosmic pixel, bit for bit the dense result.
  The windows are copied out by the CUDA kernel ``csrc/gather.cu``
  (K4), their medians run through K2 on the windows stacked into one
  plane, and each window's scatter region is written back by the
  highest window (in the JAX package's write order) that covers a
  pixel.  Above ``max_cells`` active cells a round is the dense one.
- the dense clean-once round otherwise (``windowed=False``, or a
  per-pixel read-noise map), with the sparse clean under
  ``clean_cap > 0``.

Clean-once semantics, as in the JAX package: each cosmic pixel is
replaced exactly once, in the round that detects it, so a round after
one with zero new detections is a no-op and is skipped (the count is
read on the host).
"""

from __future__ import annotations

import dataclasses

import torch

from blackbox_tpu_torch.ops.filters import (dilate, laplacian_subsampled,
                                            masked_median_filter,
                                            masked_median_rows,
                                            median_filter, median_filter_sep)
from blackbox_tpu_torch.ops.windows import gather_slot_windows
from blackbox_tpu_torch.utils.timing import count, span


@dataclasses.dataclass(frozen=True)
class LACosmicParams:
    sigclip: float = 15.0
    sigfrac: float = 0.01
    objlim: float = 3.0
    niter: int = 3
    strip_rows: int = 176       # row strip of the plain median networks
    clean_cap: int = 0          # > 0: sparse clean (unwindowed path only)
    sepmed: bool = False        # separable detection medians
    use_pallas: bool = False    # the fused iteration (K7)
    # the JAX package's switch for a TPU kernel of the dense round's 5x5
    # medians, off there by default; here K2 runs every k x k median
    pallas_medians: bool | None = None
    # round 1 placed by the separable-extrema seed superset instead of a
    # dense detection (exact; the JAX package's default is off)
    prescreen: bool = False
    # rounds 2..niter and every clean only in windows around the active
    # cells (exact, the default); a per-pixel read noise takes the dense
    # rounds
    windowed: bool = True
    cell: int = 64              # active-cell side [px]
    max_cells: int = 4096       # a round with more active cells is dense
    window_chunk: int = 256     # windows gathered and detected at a time


def lacosmic(data, inmask, rdnoise, params: LACosmicParams = LACosmicParams(),
             coords=None):
    """Detect and clean cosmic rays.

    data    : (H, W) float32, e- (sky-included, calibrated)
    inmask  : (H, W) bool — pixels excluded from detection, or None
    rdnoise : scalar or (H, W) read noise [e-]
    coords  : optional (col0, W_total) when ``data`` is a column block
              of a wider frame (the sharded path): the border masks
              then use frame coordinates, so a block's interior equals
              the whole frame's dense result there.

    Returns (cleaned data, crmask bool, per-round new-detection counts).
    """
    p = params
    if p.prescreen and (not p.windowed or p.sepmed):
        raise ValueError("LACosmicParams.prescreen requires the windowed "
                         "iteration machinery (windowed=True, "
                         "sepmed=False) — it places exact windowed "
                         "detection from the seed superset")
    if p.use_pallas:
        from blackbox_tpu_torch.ops.lacosmic_fused import lacosmic_fused
        return lacosmic_fused(data, inmask, rdnoise, sigclip=p.sigclip,
                              sigfrac=p.sigfrac, objlim=p.objlim,
                              niter=p.niter)
    if inmask is None:
        inmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    if coords is not None:
        return _lacosmic_dense_coords(data, inmask, rdnoise, p, coords)
    if p.sepmed:
        return _rounds(data, inmask, rdnoise, p,
                       lambda a, k: median_filter_sep(a, k, p.strip_rows))
    # the JAX package's windowed rounds need a scalar read noise; a map
    # takes its dense path, where the sparse clean applies
    windowed = p.windowed and torch.as_tensor(rdnoise).dim() == 0
    if p.prescreen and not windowed:
        raise ValueError("LACosmicParams.prescreen needs the windowed "
                         "path, which requires a SCALAR rdnoise — a "
                         "per-pixel read-noise map forces the dense "
                         "path and would silently skip the requested "
                         "pre-screen")
    if windowed:
        return _windowed_rounds(data, inmask, rdnoise, p)
    return _rounds(data, inmask, rdnoise, p,
                   lambda a, k: median_filter(a, k, p.strip_rows),
                   p.clean_cap)


def _read_int(t: torch.Tensor) -> int:
    """``int(t)``, a host read, counted as one."""
    count("host.reads")
    return int(t)


def _rounds(data, inmask, rdnoise, p: LACosmicParams, medf, clean_cap=0):
    """``p.niter`` clean-once rounds with detection medians ``medf``."""
    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    counts = []
    for _ in range(p.niter):
        if counts and _read_int(counts[-1]) == 0:
            # a round after a zero-new round is a no-op (clean-once)
            counts.append(counts[-1])
            continue
        cosm, m5un = _detect_math(clean, ~inmask, rdnoise, p, medf)
        new = cosm & ~crmask
        crmask = crmask | cosm
        if clean_cap > 0:
            clean = _sparse_masked_clean(clean, new, crmask | inmask,
                                         torch.clamp(m5un, min=1e-5),
                                         clean_cap)
        else:
            repl = masked_median_filter(clean, crmask | inmask, 5,
                                        p.strip_rows, fallback=m5un)
            clean = torch.where(new, repl, clean)
        counts.append(torch.sum(new, dtype=torch.int32))
    return clean, crmask, torch.stack(counts)


def _lacosmic_dense_coords(data, inmask, rdnoise, p: LACosmicParams,
                           coords):
    """Dense rounds on a column block with the border masks in frame
    coordinates (the JAX package's ``_lacosmic_dense_coords``).

    The k x k medians (K2 on the card) and the masked clean keep the
    input only on the frame's border, so a shard seam gets the stencil
    results its halo columns feed.  The block's own outer columns (its
    halo) may differ from the JAX package's edge-padded medians; the
    caller discards them.  The rounds run ``p.niter`` times with no
    early exit, which needs the frame's count; a round after one with
    no new detection is a no-op (clean-once), so the result is the
    guarded dense path's.  The clean keeps a NaN median, as the JAX
    package's windowed clean does.
    """
    col0, W_total = coords
    H, W = data.shape
    dev = data.device
    ri = torch.arange(H, device=dev)[:, None]
    ci = (int(col0) + torch.arange(W, device=dev))[None, :]

    def bk(pk):
        return (ri < pk) | (ri >= H - pk) | (ci < pk) | (ci >= W_total - pk)

    ring = (ri == 0) | (ri == H - 1) | (ci == 0) | (ci == W_total - 1)
    border2 = bk(2)

    def medf(a, k):
        return torch.where(bk(k // 2), a, median_filter(a, k, p.strip_rows))

    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=dev)
    counts = []
    for _ in range(p.niter):
        cosm, m5un = _detect_math(clean, ~inmask, rdnoise, p, medf,
                                  lambda v: laplacian_subsampled(v, ring))
        new = cosm & ~crmask
        counts.append(torch.sum(new, dtype=torch.int32))
        crmask = crmask | cosm
        repl = masked_median_filter(clean, crmask | inmask, 5, p.strip_rows,
                                    fallback=m5un, nan_fallback=False)
        clean = torch.where(new & ~border2, repl, clean)
    return clean, crmask, torch.stack(counts)


def _detect_math(clean, good, rdnoise, p: LACosmicParams, medf,
                 lapf=laplacian_subsampled):
    """One L.A.Cosmic detection round with border-keeping k x k medians
    ``medf(a, k)`` and the ring-zeroed subsampled Laplacian ``lapf``.

    Returns (cosm bool, unclamped 5x5 median of ``clean``).
    """
    m5un = medf(clean, 5)
    # noise model from the 5x5 median (gain = 1: data already in e-)
    m5 = torch.clamp(m5un, min=1e-5)
    noise = torch.sqrt(m5 + rdnoise ** 2)

    # Laplacian SNR, large-scale structure removed
    s = lapf(clean) / (2.0 * noise)
    sp = s - medf(s, 5)

    # fine structure: med3 - med7(med3), floor 0.01
    m3 = medf(clean, 3)
    m37 = medf(m3, 7)
    f = torch.clamp((m3 - m37) / noise, min=0.01)

    cosm = (sp > p.sigclip) & (sp / f > p.objlim) & good
    # grow to neighbours that are also significant
    cosm = dilate(cosm, 3) & (sp > p.sigclip) & good
    # wider growth at the reduced threshold
    cosm = dilate(cosm, 5) & (sp > p.sigclip * p.sigfrac) & good
    return cosm, m5un


def _windowed_rounds(data, inmask, rdnoise, p: LACosmicParams):
    """The JAX package's windowed rounds, in its order: round 1 a dense
    detection and a windowed clean (or, with ``prescreen``, a windowed
    detection and clean placed by the seed superset), rounds 2..niter
    windowed, each skipped after a round with no new pixel."""
    clean = data
    crmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    counts = []
    for it in range(p.niter):
        if it == 0 and p.prescreen:
            seeds = _prescreen_seeds(clean, ~inmask, rdnoise, p)
            clean, crmask, _ = _windowed_pass(clean, crmask, inmask,
                                              rdnoise, p, True, seeds)
            counts.append(torch.sum(crmask, dtype=torch.int32))
        elif it == 0:
            cosm, _ = _detect_math(
                clean, ~inmask, rdnoise, p,
                lambda a, k: median_filter(a, k, p.strip_rows))
            counts.append(torch.sum(cosm & ~crmask, dtype=torch.int32))
            crmask = crmask | cosm
            clean, crmask, _ = _windowed_pass(clean, crmask, inmask,
                                              rdnoise, p, False)
        elif _read_int(counts[-1]) == 0:
            # a round after a zero-new round is a no-op (clean-once)
            counts.append(counts[-1])
        else:
            prev = torch.sum(crmask, dtype=torch.int32)
            clean, crmask, _ = _windowed_pass(clean, crmask, inmask,
                                              rdnoise, p, True)
            counts.append(torch.sum(crmask, dtype=torch.int32) - prev)
    return clean, crmask, torch.stack(counts)


_WIN_MARGIN = 24      # data halo per window side (>= 21 = worst-case
                      # stencil composition: 12 scatter + 2 clean + 7
                      # detect); 24 leaves slack
_SCAT_MARGIN = 12     # scatter halo: covers detect radius 7 + clean 2


def _edge_pad(a, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of the last two dimensions (any dtype)."""
    H, W = a.shape[-2:]
    dev = a.device
    rows = torch.arange(-top, H + bottom, device=dev).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=dev).clamp(0, W - 1)
    return a.index_select(-2, rows).index_select(-1, cols)


def _extrema5_sep(a, maximum: bool):
    """Edge-padded separable 5x5 running max or min (NaN-propagating,
    like the JAX package's ``lax.reduce_window``)."""
    H, W = a.shape
    ap = _edge_pad(a, 2, 2, 2, 2)
    op = torch.maximum if maximum else torch.minimum
    out = ap[0:H]
    for d in range(1, 5):
        out = op(out, ap[d:d + H])
    res = out[:, 0:W]
    for d in range(1, 5):
        res = op(res, out[:, d:d + W])
    return res


def _prescreen_seeds(clean, good, rdnoise, p: LACosmicParams):
    """Cheap exact superset of the round-1 seed pixels.

    The seed test is ``sp > sigclip`` with ``sp = s - med5(s)``,
    ``s = lap / (2*sqrt(max(med5(clean), 1e-5) + rd²))``; separable
    extrema bound it from above (min5 <= med5 <= max5):

      s_hi  = max(lap, 0) / (2*noise_lo)              >= s
      s_lo  = lap / (2*noise_hi if lap >= 0 else 2*noise_lo)  <= s
      sp_hi = s_hi - min5(s_lo)  >=  s - med5(s) = sp

    so ``sp_hi > sigclip`` can only add pixels; the exact windowed
    detection then runs around their cells.
    """
    lap = laplacian_subsampled(clean)
    m5_lo = torch.clamp(_extrema5_sep(clean, False), min=1e-5)
    m5_hi = torch.clamp(_extrema5_sep(clean, True), min=1e-5)
    noise_lo = torch.sqrt(m5_lo + rdnoise ** 2)
    noise_hi = torch.sqrt(m5_hi + rdnoise ** 2)
    s_hi = torch.clamp(lap, min=0.0) / (2.0 * noise_lo)
    s_lo = torch.where(lap >= 0.0, lap / (2.0 * noise_hi),
                       lap / (2.0 * noise_lo))
    sp_hi = s_hi - _extrema5_sep(s_lo, False)
    return (sp_hi > p.sigclip) & good


def _win_median(a, k: int, border_keep, strip_rows: int):
    """k x k median of each window of ``a`` (N, S, S), each edge-padded
    by k//2 inside itself (the JAX package's ``_win_median``), in one
    K2 launch: the padded windows stacked along rows into one
    (N (S + 2p), S + 2p) plane, whose interior pixels of a window read
    only that window's rows.  ``border_keep`` marks the frame-border
    pixels that keep the input."""
    N, S, _ = a.shape
    pk = k // 2
    T = S + 2 * pk
    plane = _edge_pad(a, pk, pk, pk, pk).reshape(N * T, T)
    med = median_filter(plane, k, strip_rows).reshape(N, T, T)
    return torch.where(border_keep, a, med[:, pk:pk + S, pk:pk + S])


def _win_masked_median(a, bad, fallback, border_keep):
    """Masked 5x5 median of each window (the JAX package's
    ``_win_masked_median``): edge-padded inside the window, all-bad ->
    ``fallback``, a NaN median kept, frame border -> input."""
    med = masked_median_rows(_edge_pad(a, 2, 2, 2, 2),
                             _edge_pad(bad, 2, 2, 2, 2), 5, fallback,
                             nan_fallback=False)
    return torch.where(border_keep, a, med)


class _Frames:
    """Frame-coordinate masks of a batch of WS x WS windows whose frame
    origins are ``oy``, ``ox`` (N,): ``in_f`` (inside the frame),
    ``bk(pk)`` (within pk of the frame's edge) and ``ring`` (the frame's
    outer ring), each (N, WS, WS)."""

    def __init__(self, oy, ox, WS: int, H: int, W: int):
        g = torch.arange(WS, device=oy.device)
        self.ys = (oy[:, None] + g[None, :])[:, :, None]
        self.xs = (ox[:, None] + g[None, :])[:, None, :]
        self.H, self.W = H, W
        self.in_f = ((self.ys >= 0) & (self.ys < H)
                     & (self.xs >= 0) & (self.xs < W))
        self.ring = ((self.ys == 0) | (self.ys == H - 1)
                     | (self.xs == 0) | (self.xs == W - 1))

    def bk(self, pk: int):
        return ((self.ys < pk) | (self.ys >= self.H - pk)
                | (self.xs < pk) | (self.xs >= self.W - pk))


def _windowed_pass(clean, crmask, inmask, rdnoise, p: LACosmicParams,
                   detect: bool, place_mask=None):
    """One exact L.A.Cosmic round evaluated only in windows around the
    active cells (the JAX package's ``_windowed_pass``).

    detect=True  : detection and clean (rounds >= 2, or round 1 with
                   ``place_mask`` the seed superset).
    detect=False : the clean only, after a dense detection.
    place_mask   : the map that places the windows (default: crmask).

    A cell of ``p.cell`` px is active when a pixel of it is set in the
    placing map; the first ``cap = min(max_cells, cells)`` active cells,
    in raster order, are the slots.  Each slot's window (its cell and a
    ``_WIN_MARGIN`` halo, from the edge-padded planes) is gathered by
    K4, ``window_chunk`` at a time; a window with a new pixel is
    cleaned and writes its cell plus a ``_SCAT_MARGIN`` halo back.
    Where two such regions overlap, the window the JAX package writes
    last wins: it writes chunk by chunk, slot by slot, and its last
    chunk, when ``cap`` is not a multiple of the chunk, starts at
    ``cap - chunk`` (``lax.dynamic_slice_in_dim`` clamps the start), so
    that chunk runs earlier slots again and may leave its last slots
    unvisited; the port runs the same slots in the same order.

    Host reads, each counted in ``host.reads``: the active cells
    (nact), the windows with a new pixel, then the boolean-mask gathers
    of the scatter (two, and three a chunk of changed windows).  Above
    ``cap`` active cells the round is the dense one.
    Returns (clean, crmask, info): info holds nact, the branch taken,
    the chunks run, the windows gathered (chunks x chunk) and the
    windows that changed; a span ``lacosmic.pass`` carries it.
    """
    with span("lacosmic.pass") as s:
        out = _pass_in_windows(clean, crmask, inmask, rdnoise, p, detect,
                               place_mask)
        s.set(**out[2])
    return out


def _pass_in_windows(clean, crmask, inmask, rdnoise, p: LACosmicParams,
                     detect: bool, place_mask):
    H, W = clean.shape
    dev = clean.device
    CS, M, SM = p.cell, _WIN_MARGIN, _SCAT_MARGIN
    WS = CS + 2 * M
    Hc, Wc = -(-H // CS), -(-W // CS)
    cap = min(p.max_cells, Hc * Wc)
    chunk = min(p.window_chunk, cap)

    # ---- active cells (one host read: their number) -------------------
    pm = crmask if place_mask is None else place_mask
    crp = torch.zeros((Hc * CS, Wc * CS), dtype=torch.bool, device=dev)
    crp[:H, :W] = pm
    cell_any = crp.reshape(Hc, CS, Wc, CS).any(3).any(1)
    pos = torch.nonzero(cell_any.reshape(-1))[:, 0]
    count("host.reads")
    nact = pos.numel()
    if nact > cap:
        return (*_dense_pass(clean, crmask, inmask, rdnoise, p, detect),
                dict(nact=nact, branch="dense", chunks=0, windows=0,
                     changed=0))
    if nact == 0:
        return clean, crmask, dict(nact=0, branch="windowed", chunks=0,
                                   windows=0, changed=0)
    # slots past nact point at the last cell, as the JAX package's
    # searchsorted does; no window of them is used
    slots = torch.full((cap,), Hc * Wc - 1, dtype=torch.long, device=dev)
    slots[:nact] = pos

    # ---- padded planes (edge-padded like the dense strip pipeline) ----
    pad = (M, Hc * CS - H + M, M, Wc * CS - W + M)
    Pc = _edge_pad(clean, *pad)
    Pi = _edge_pad(inmask.to(torch.float32), *pad)
    Pm = _edge_pad(crmask.to(torch.float32), *pad)

    # ---- detection, a chunk of windows at a time ----------------------
    starts = range(0, nact, chunk)
    n = len(starts) * chunk
    CW = torch.empty((n, WS, WS), dtype=clean.dtype, device=dev)
    IW = torch.empty((n, WS, WS), dtype=torch.float32, device=dev)
    NEW = torch.empty((n, WS, WS), dtype=torch.bool, device=dev)
    CRM = torch.empty((n, WS, WS), dtype=torch.bool, device=dev)
    M5 = torch.empty((n, WS, WS), dtype=clean.dtype, device=dev)
    CH = torch.empty((n,), dtype=torch.bool, device=dev)
    Y0 = torch.empty((n,), dtype=torch.long, device=dev)
    X0 = torch.empty((n,), dtype=torch.long, device=dev)
    for i, c0 in enumerate(starts):
        s0 = min(c0, cap - chunk)
        nin = min(nact - c0, chunk)
        sl = slots[s0:s0 + chunk]
        y0, x0 = (sl // Wc) * CS, (sl % Wc) * CS
        cw, iw, mw = gather_slot_windows(
            (Pc, Pi, Pm), y0, x0, WS, n_active=None if nin == chunk else nin)
        fr = _Frames(y0 - M, x0 - M, WS, H, W)

        def medf(a, k):
            return _win_median(a, k, fr.bk(k // 2), p.strip_rows)

        good = (iw <= 0.5) & fr.in_f
        crm0 = mw > 0.5
        if detect:
            cosm, m5un = _detect_math(
                cw, good, rdnoise, p, medf,
                lambda v: laplacian_subsampled(v, fr.ring))
            cosm = cosm & fr.in_f
            new = cosm & ~crm0
            crm = crm0 | cosm
        else:
            # after a dense detection every placed pixel is new
            m5un = medf(cw, 5)
            new = crm = crm0
        b = slice(i * chunk, (i + 1) * chunk)
        CW[b], IW[b], NEW[b], CRM[b], M5[b] = cw, iw, new, crm, m5un
        # slots at or past nact gathered zeros: they never scatter
        CH[b] = new.any(2).any(1) & (torch.arange(chunk, device=dev) < nin)
        Y0[b], X0[b] = y0, x0

    # ---- clean and scatter the windows with a new pixel (one read) ----
    chg = torch.nonzero(CH)[:, 0]
    count("host.reads")
    info = dict(nact=nact, branch="windowed", chunks=len(starts),
                windows=n, changed=chg.numel())
    if chg.numel() == 0:
        return clean, crmask, info
    # each pixel of a scatter region goes to the last window the JAX
    # package writes there: the highest position in run order
    R = CS + 2 * SM
    g = torch.arange(R, device=dev)
    ys = (Y0[chg] - SM)[:, None] + g[None, :]
    xs = (X0[chg] - SM)[:, None] + g[None, :]
    inb = (((ys >= 0) & (ys < H))[:, :, None]
           & ((xs >= 0) & (xs < W))[:, None, :])
    flat = (ys.clamp(0, H - 1) * W)[:, :, None] + xs.clamp(0, W - 1)[:, None,
                                                                       :]
    order = chg.to(torch.int32)[:, None, None].expand(-1, R, R)
    owner = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    owner.scatter_reduce_(0, flat[inb], order[inb], "amax")
    count("host.reads", 2)          # the two boolean-mask gathers
    mine = inb & (owner[flat] == order)
    out_c, out_m = clean.clone(), crmask.clone()
    for b0 in range(0, chg.numel(), chunk):
        b = slice(b0, b0 + chunk)
        w = chg[b]
        fr = _Frames(Y0[w] - M, X0[w] - M, WS, H, W)
        bad = CRM[w] | (IW[w] > 0.5)
        repl = _win_masked_median(CW[w], bad, M5[w], fr.bk(2))
        cleaned = torch.where(NEW[w], repl, CW[w])
        r = slice(M - SM, M + CS + SM)
        keep = mine[b]
        idx = flat[b][keep]
        out_c.view(-1)[idx] = cleaned[:, r, r][keep]
        out_m.view(-1)[idx] = CRM[w][:, r, r][keep]
        count("host.reads", 3)      # the three boolean-mask gathers
    return out_c, out_m, info


def _dense_pass(clean, crmask, inmask, rdnoise, p: LACosmicParams,
                detect: bool):
    """The dense form of :func:`_windowed_pass` (more active cells than
    its cap): a dense round, or the dense clean after a dense
    detection; the clean takes the fallback for a NaN median."""
    if detect:
        cosm, m5un = _detect_math(
            clean, ~inmask, rdnoise, p,
            lambda a, k: median_filter(a, k, p.strip_rows))
        new = cosm & ~crmask
        crm = crmask | cosm
    else:
        m5un = median_filter(clean, 5, p.strip_rows)
        new = crm = crmask
    repl = masked_median_filter(clean, crm | inmask, 5, p.strip_rows,
                                fallback=m5un)
    return torch.where(new, repl, clean), crm


def _sparse_masked_clean(clean, crmask, bad, m5, cap: int):
    """Replace the first ``cap`` cosmic pixels (raster order) by the
    masked 5x5 median of their good neighbours, evaluated only there.

    Pixels within 2 px of the frame edge keep their value; an all-bad
    neighbourhood takes ``m5`` (the CLAMPED 5x5 median).  Plain PyTorch
    on every device (the JAX package has no kernel for it).
    """
    H, W = clean.shape
    pos = torch.nonzero(crmask.reshape(-1))[:cap, 0]
    py, px = pos // W, pos % W
    keep = (py >= 2) & (py < H - 2) & (px >= 2) & (px < W - 2)
    py, px = py[keep], px[keep]
    count("host.reads", 3)          # the nonzero and two boolean gathers
    off = torch.arange(-2, 3, device=clean.device)
    wy = (py[:, None, None] + off[None, :, None]).expand(-1, 5, 5)
    wx = (px[:, None, None] + off[None, None, :]).expand(-1, 5, 5)
    b = bad[wy, wx].reshape(-1, 25)
    vals = torch.where(b, 3.0e38, clean[wy, wx].reshape(-1, 25))
    s = torch.sort(vals, dim=1).values
    n = torch.sum(~b, dim=1)
    lo = s.gather(1, (torch.clamp(n - 1, min=0) // 2)[:, None])[:, 0]
    hi = s.gather(1, (n // 2)[:, None])[:, 0]
    med = torch.where(n > 0, 0.5 * (lo + hi), m5[py, px])
    out = clean.clone()
    out[py, px] = med
    return out
