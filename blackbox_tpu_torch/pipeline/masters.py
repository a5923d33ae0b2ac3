"""Master bias / dark / flat construction as device median stacks (port
of :mod:`blackbox_tpu.pipeline.masters`).

Calibrated frames are median-combined as one float32 cube on the
device.  Master flats are first normalised by their STATSEC medians,
non-positive and edge pixels are set to 1, and the 16 channel
gain-correction factors (GAINCF1..16) come from matching channel
medians vertically across the CCD centre line, then chaining them
horizontally across channel boundaries.  Medians are ``jnp.median``'s
(``ops.stats.median``: the mean of the two middle values for an even
count).

:func:`build_master` is the device program of one master, from the
frames' channel stacks to the master and its statistics: the night's
``MasterStore`` and the benchmark both call it.  Its stages are
module-level functions (:func:`stack_median`, :func:`normalise`,
:func:`gaincf`), each called once a master through this module, and
spans of :mod:`blackbox_tpu_torch.utils.timing`: ``master`` (attributes
``imgtype``, ``frames``, ``planes``) over ``master.stack``,
``master.median`` (``route``, ``kernel`` or ``sort`` as
``ops.stats.median_route`` gives it, and ``N``), ``master.normalise``
and ``master.gaincf`` (flats) and ``master.stats``; the counter
``master.frames`` counts the frames stacked.
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.core.geometry import CCDGeometry
from blackbox_tpu_torch.ops.stats import (masked_mean_std, median,
                                          median_route)
from blackbox_tpu_torch.utils.timing import count, span


def build_master(imgtype: str, frames: list, geom: CCDGeometry,
                 norm_sec=None, exptimes=None):
    """One master from its frames, on the frames' device.

    imgtype  : "bias", "flat" or "dark"
    frames   : list of (C, ych, xch) calibrated channel stacks [e-]; the
               list is emptied once they are stacked, so that frames no
               other reference holds are freed before the median
    norm_sec : (slice, slice) on the reduced mosaic for a flat; None
               normalises on the mosaic's central quarter
    exptimes : (N,) exposure times of a dark's frames [s]

    Returns (master (C, ych, xch), stats) as ``master_bias``,
    ``master_flat`` or ``master_dark`` give them.
    """
    n = len(frames)
    with span("master", imgtype=imgtype, frames=n,
              planes=int(frames[0].shape[0])):
        count("master.frames", n)
        with span("master.stack"):
            cube = torch.stack(frames)             # (N, C, ych, xch)
        frames.clear()
        if imgtype == "flat":
            if norm_sec is None:
                H, W = geom.red_shape
                norm_sec = (slice(H // 2 - H // 8, H // 2 + H // 8),
                            slice(W // 2 - W // 8, W // 2 + W // 8))
            return master_flat(cube, geom, norm_sec)
        if imgtype == "dark":
            return master_dark(cube, exptimes)
        return master_bias(cube)


def stack_median(cube):
    """The median over the frames' axis of an (N, C, ych, xch) cube."""
    with span("master.median", route=median_route(cube, 0),
              N=int(cube.shape[0])):
        return median(cube, axis=0)


def master_bias(stack):
    """Median-combine calibrated bias frames.

    stack : (N, C, ych, xch) [e-]
    Returns (master (C, ych, xch), stats dict with per-channel mean/std).
    """
    master = stack_median(stack)
    C = master.shape[0]
    with span("master.stats"):
        mean, std = masked_mean_std(master.reshape(C, -1), axis=1)
        return master, {
            "mbias_chan_mean": mean,       # MBMEAN{c}
            "mbias_chan_std": std,         # MBSTD{c}
            "mbias_mean": torch.mean(mean),
            "mbias_std": torch.mean(std),
            "nmbias": torch.tensor(stack.shape[0], dtype=torch.int32),
        }


def master_flat(stack, geom: CCDGeometry, norm_sec, bpm=None,
                nrows_vert: int | None = None,
                nrows_hori: int | None = None,
                ncols_hori: int | None = None):
    """Median-combine normalised flats and derive GAINCF factors.

    stack    : (N, C, ych, xch) calibrated flats [e-]
    norm_sec : (slice, slice) on the reduced mosaic (flat_norm_sec)
    bpm      : optional (C, ych, xch) uint8 mask (edge bit -> set to 1)

    Returns (master (C, ych, xch), stats: medsec per input, gaincf (C,)).
    """
    N = stack.shape[0]
    normed, medsec = normalise(stack, geom, norm_sec)
    master = stack_median(normed)
    del normed

    # edge / non-positive -> 1
    bad = master <= 0
    if bpm is not None:
        bad = bad | ((torch.as_tensor(bpm, device=master.device)
                      & maskbits.EDGE) != 0)
    master = torch.where(bad, 1.0, master)

    factor = gaincf(master, geom, nrows_vert, nrows_hori, ncols_hori)
    with span("master.stats"):
        stats = {
            "medsec": medsec,                  # per-input normalisation [e-]
            "gaincf": factor,                  # GAINCF1..16
            "nmflat": torch.tensor(N, dtype=torch.int32),
            "mflat_med": median(master),
        }
    return master, stats


def normalise(stack, geom: CCDGeometry, norm_sec):
    """Each flat divided by its STATSEC median: (normed stack, medsec
    (N,)).  Only the section of each assembled mosaic is kept."""
    with span("master.normalise"):
        N = stack.shape[0]
        medsec = median(torch.stack(
            [geom.assemble(stack[i])[norm_sec[0], norm_sec[1]]
             for i in range(N)]).reshape(N, -1), axis=1)
        normed = stack / torch.clamp(medsec, min=1e-6)[:, None, None, None]
        return normed, medsec


def gaincf(master, geom: CCDGeometry, nrows_vert: int | None = None,
           nrows_hori: int | None = None, ncols_hori: int | None = None):
    """GAINCF1..16 of a master flat (C, ych, xch): channel medians
    matched vertically across the centre line, then chained
    horizontally across channel boundaries, normalised to mean 1."""
    with span("master.gaincf"):
        _, ych, xch = master.shape
        nx = geom.nx

        # ---- vertical matching across the centre line ----
        nr = nrows_vert or max(min(200, ych // 4), 1)
        bottom_strip = master[:nx, ych - nr:, :]   # rows adjacent to centre
        top_strip = master[nx:, :nr, :]
        med_cntr = torch.cat([median(bottom_strip.reshape(nx, -1), axis=1),
                              median(top_strip.reshape(nx, -1), axis=1)])
        factor = 1.0 / torch.clamp(med_cntr, min=1e-6)
        corr = master * factor[:, None, None]

        # ---- horizontal chaining on the corrected mosaic ----
        nrh = nrows_hori or max(min(2000, ych), 1)
        nch = ncols_hori or max(min(200, xch // 4), 1)
        mosaic = geom.assemble(corr)
        dy = ych
        ratios = [torch.ones((), dtype=torch.float32, device=master.device)]
        for i in range(1, nx):
            xb = i * xch
            left = mosaic[dy - nrh:dy + nrh, xb - nch:xb]
            right = mosaic[dy - nrh:dy + nrh, xb:xb + nch]
            ratios.append(median(left)
                          / torch.clamp(median(right), min=1e-6))
        chain = torch.cumprod(torch.stack(ratios), dim=0)     # (nx,)
        factor = factor * chain.repeat(2)
        return factor / torch.mean(factor)


def master_dark(stack, exptimes):
    """Median-combine dark frames scaled to 1 s."""
    exptimes = torch.as_tensor(exptimes, dtype=stack.dtype,
                               device=stack.device)
    scaled = stack / torch.clamp(exptimes, min=1e-6)[:, None, None, None]
    master = stack_median(scaled)
    C = master.shape[0]
    with span("master.stats"):
        mean, std = masked_mean_std(master.reshape(C, -1), axis=1)
        return master, {"mdark_chan_mean": mean, "mdark_chan_std": std,
                        "nmdark": torch.tensor(stack.shape[0],
                                               dtype=torch.int32)}
