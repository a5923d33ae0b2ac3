"""Master bias / dark / flat construction as median stacks: a frozen copy
of the port's ``pipeline/masters.py`` (its equations and their order),
without spans, with the imports rewritten to this package.

One departure, which changes no value: :func:`stack_median` takes the
median one channel at a time, so that it fits on the card beside the
benchmark's frame banks after the window.  Order statistics are exact,
so the result is the whole cube's median bit for bit.
"""

from __future__ import annotations

import torch

from portbench.reference.core import maskbits
from portbench.reference.core.geometry import CCDGeometry
from portbench.reference.ops.stats import masked_mean_std, median


def build_master(imgtype: str, frames: list, geom: CCDGeometry,
                 norm_sec=None, exptimes=None):
    """One master from a list of (C, ych, xch) channel stacks: (master,
    stats).  A flat without ``norm_sec`` is normalised on the mosaic's
    central quarter."""
    cube = torch.stack(frames)                     # (N, C, ych, xch)
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
    """The median over the frames' axis of an (N, C, ych, xch) cube, one
    channel at a time."""
    return torch.stack([median(cube[:, c], axis=0)
                        for c in range(cube.shape[1])])


def master_bias(stack):
    """(master (C, ych, xch), per-channel mean and std)."""
    master = stack_median(stack)
    C = master.shape[0]
    mean, std = masked_mean_std(master.reshape(C, -1), axis=1)
    return master, {
        "mbias_chan_mean": mean,
        "mbias_chan_std": std,
        "mbias_mean": torch.mean(mean),
        "mbias_std": torch.mean(std),
        "nmbias": torch.tensor(stack.shape[0], dtype=torch.int32),
    }


def master_flat(stack, geom: CCDGeometry, norm_sec, bpm=None,
                nrows_vert: int | None = None,
                nrows_hori: int | None = None,
                ncols_hori: int | None = None):
    """(master (C, ych, xch), stats: medsec per input, gaincf (C,),
    nmflat, mflat_med)."""
    N = stack.shape[0]
    normed, medsec = normalise(stack, geom, norm_sec)
    master = stack_median(normed)
    del normed
    bad = master <= 0
    if bpm is not None:
        bad = bad | ((torch.as_tensor(bpm, device=master.device)
                      & maskbits.EDGE) != 0)
    master = torch.where(bad, 1.0, master)
    factor = gaincf(master, geom, nrows_vert, nrows_hori, ncols_hori)
    return master, {"medsec": medsec, "gaincf": factor,
                    "nmflat": torch.tensor(N, dtype=torch.int32),
                    "mflat_med": median(master)}


def normalise(stack, geom: CCDGeometry, norm_sec):
    """(each flat over its section's median, medsec (N,))."""
    N = stack.shape[0]
    medsec = median(torch.stack(
        [geom.assemble(stack[i])[norm_sec[0], norm_sec[1]]
         for i in range(N)]).reshape(N, -1), axis=1)
    normed = stack / torch.clamp(medsec, min=1e-6)[:, None, None, None]
    return normed, medsec


def gaincf(master, geom: CCDGeometry, nrows_vert: int | None = None,
           nrows_hori: int | None = None, ncols_hori: int | None = None):
    """GAINCF1..16: vertical matching across the centre line, then the
    horizontal chain, normalised to mean 1."""
    _, ych, xch = master.shape
    nx = geom.nx
    nr = nrows_vert or max(min(200, ych // 4), 1)
    bottom_strip = master[:nx, ych - nr:, :]
    top_strip = master[nx:, :nr, :]
    med_cntr = torch.cat([median(bottom_strip.reshape(nx, -1), axis=1),
                          median(top_strip.reshape(nx, -1), axis=1)])
    factor = 1.0 / torch.clamp(med_cntr, min=1e-6)
    corr = master * factor[:, None, None]
    nrh = nrows_hori or max(min(2000, ych), 1)
    nch = ncols_hori or max(min(200, xch // 4), 1)
    mosaic = geom.assemble(corr)
    dy = ych
    ratios = [torch.ones((), dtype=torch.float32, device=master.device)]
    for i in range(1, nx):
        xb = i * xch
        left = mosaic[dy - nrh:dy + nrh, xb - nch:xb]
        right = mosaic[dy - nrh:dy + nrh, xb:xb + nch]
        ratios.append(median(left) / torch.clamp(median(right), min=1e-6))
    chain = torch.cumprod(torch.stack(ratios), dim=0)
    factor = factor * chain.repeat(2)
    return factor / torch.mean(factor)


def master_dark(stack, exptimes):
    """Dark frames scaled to 1 s, median-combined."""
    exptimes = torch.as_tensor(exptimes, dtype=stack.dtype,
                               device=stack.device)
    scaled = stack / torch.clamp(exptimes, min=1e-6)[:, None, None, None]
    master = stack_median(scaled)
    C = master.shape[0]
    mean, std = masked_mean_std(master.reshape(C, -1), axis=1)
    return master, {"mdark_chan_mean": mean, "mdark_chan_std": std,
                    "nmdark": torch.tensor(stack.shape[0],
                                           dtype=torch.int32)}
