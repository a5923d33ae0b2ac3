"""Entry ``masters``: ``pipeline.masters.build_master``, one master bias or
flat from a night's reduced calibration frames, as ``MasterStore._build``
calls it once the frames are read and on the device.

Set-up makes, on the device from the seed, a bank of reduced bias frames
and a bank of reduced twilight flats (channel stacks in e-); each pool
item names one master of the night's job, in the traffic's
``sequence`` (``bias``, then a flat in each filter), and the bank frames
it stacks, as an int64 index tensor on the host: a bias item a seeded,
distinct ``ncal_max["bias"]`` of the bias bank, a flat item
``ncal_max["flat"]`` of the flat bank, each leaving out another frame,
in an order of its own.  One call is one master, so ``frames_per_s``
reads masters a second.  The Rice reads and the upload that precede the
call on the night's path are not timed.

Its traffic file gives ``sequence``, ``bias_bank``, ``flat_bank``,
``bias`` (``offset_e``, ``column_pattern_e``, ``cosmics``,
``cosmic_e``) and ``flat`` (``vignetting``, ``pixel_response``,
``channel_gain``, ``stars_per_mpix``, ``star_flux_e``,
``star_fwhm_pix``); the configuration gives ``ncal_max``, ``norm_sec``
and, under ``assumed``, ``bias_read_noise_e`` and ``flat_level_e``.

What the benchmark's tests need of it: :func:`tiny`, :func:`control`
(the cube that ``stack_median`` receives, held in bfloat16),
:func:`witness` (that cube moved by a unit in the last place),
``FAULTS`` and ``PROGRAM_VALUES``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench import compare, faults, frames
from portbench.package import Inputs, Package
from portbench.reference.core import geometry

# build_master opens spans and counts frames, none of which
# program_trace.py reads as a value
PROGRAM_VALUES = frozenset()
_SAMPLE = 7             # every 7th pixel of a channel for its noise


def tiny(config: dict, traffic: dict) -> tuple:
    """The cell cut to the port's TINY geometry for the CPU tests; the
    banks and the depths stay as they are."""
    config["geometry"] = "TINY"
    return config, traffic


@dataclasses.dataclass
class MasterInputs(Inputs):
    bias_bank: torch.Tensor = None      # (bias_bank, C, ych, xch) [e-]
    flat_bank: torch.Tensor = None      # (flat_bank, C, ych, xch) [e-]


def _bias_bank(gen, shape, n: int, p: dict, read_noise) -> torch.Tensor:
    """``n`` reduced bias frames: a channel offset, a fixed column
    pattern, read noise spaced over ``read_noise`` by channel, and
    single-pixel cosmics."""
    C, h, w = shape
    dev = gen.device
    offset = p["offset_e"] * (2 * torch.rand((C, 1, 1), generator=gen,
                                             device=dev) - 1)
    columns = p["column_pattern_e"] * torch.randn((C, 1, w), generator=gen,
                                                  device=dev)
    sigma = frames._spaced(gen, C, *read_noise)[:, None, None]
    lo, hi = p["cosmic_e"]
    bank = torch.empty((n, C, h, w), device=dev)
    for i in range(n):
        f = bank[i]
        torch.randn((C, h, w), generator=gen, device=dev, out=f)
        f.mul_(sigma).add_(offset + columns)
        k = p["cosmics"]
        at = torch.randint(C * h * w, (k,), generator=gen, device=dev)
        f.view(-1).index_put_((at,), frames._uniform(gen, k, lo, hi),
                              accumulate=True)
    return bank


def _response(gen, geom, p: dict) -> torch.Tensor:
    """A flat's fixed pattern (C, ych, xch): the radial vignetting over
    the mosaic, the pixel response and each channel's residual gain."""
    H, W = geom.red_shape
    dev = gen.device
    y = (torch.arange(H, device=dev) - (H - 1) / 2) / (H / 2)
    x = (torch.arange(W, device=dev) - (W - 1) / 2) / (W / 2)
    vign = 1 - p["vignetting"] * 0.5 * (y[:, None] ** 2 + x[None, :] ** 2)
    resp = geom.disassemble(vign)
    del vign
    C = resp.shape[0]
    resp = resp * (1 + p["pixel_response"] * torch.randn(
        resp.shape, generator=gen, device=dev))
    gain = 1 + p["channel_gain"] * (2 * torch.rand(C, generator=gen,
                                                   device=dev) - 1)
    return resp * gain[:, None, None]


def _stars(gen, shape, p: dict) -> torch.Tensor:
    """Faint stars at random places of the channel stacks, as Gaussian
    9 x 9 stamps, fluxes spaced in log over ``star_flux_e``."""
    C, h, w = shape
    dev = gen.device
    n = max(1, round(p["stars_per_mpix"] * C * h * w / 1e6))
    c = torch.randint(C, (n,), generator=gen, device=dev)
    yc = frames._uniform(gen, n, 0, h - 1)
    xc = frames._uniform(gen, n, 0, w - 1)
    lo, hi = p["star_flux_e"]
    flux = frames._spaced(gen, n, math.log(lo), math.log(hi)).exp()
    s = p["star_fwhm_pix"] / (2 * math.sqrt(2 * math.log(2)))
    d = torch.arange(-4, 5, device=dev)
    yy = (yc.round().long()[:, None, None]
          + d[None, :, None]).expand(-1, 9, 9)
    xx = (xc.round().long()[:, None, None]
          + d[None, None, :]).expand(-1, 9, 9)
    r2 = (yy - yc[:, None, None]) ** 2 + (xx - xc[:, None, None]) ** 2
    val = flux[:, None, None] * torch.exp(-r2 / (2 * s * s)) / (
        2 * math.pi * s * s)
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    out = torch.zeros(shape, device=dev)
    out.index_put_((c[:, None, None].expand(-1, 9, 9)[inside], yy[inside],
                    xx[inside]), val[inside], accumulate=True)
    return out


def _flat_bank(gen, geom, n: int, p: dict, levels) -> torch.Tensor:
    """``n`` reduced twilight flats: a level drawn in ``levels`` times
    the fixed pattern, dithered stars, Poisson noise."""
    resp = _response(gen, geom, p)
    bank = torch.empty((n, *resp.shape), device=gen.device)
    for i in range(n):
        level = float(levels[0]) + (levels[1] - levels[0]) * torch.rand(
            (), generator=gen, device=gen.device)
        f = bank[i]
        torch.add(_stars(gen, resp.shape, p), level, out=f)
        f.mul_(resp)
        f.add_(f.clamp(min=0).sqrt() * torch.randn(
            f.shape, generator=gen, device=gen.device))
    return bank


def _items(traffic: dict, depth: dict, seed: int, pool: int) -> list:
    """(kind, filter, frame indices) of the pool's masters in the
    traffic's sequence; each master of a kind leaves out another bank
    frame, in turn, and orders the rest anew."""
    seq = traffic["sequence"]
    bank = {"bias": traffic["bias_bank"], "flat": traffic["flat_bank"]}
    g = frames.generator(seed, 4, device="cpu")
    left = {k: torch.randperm(n, generator=g) for k, n in bank.items()}
    used = {k: 0 for k in bank}
    items = []
    for i in range(pool):
        filt = seq[i % len(seq)]
        kind = "bias" if filt == "bias" else "flat"
        out = int(left[kind][used[kind] % bank[kind]])
        used[kind] += 1
        rest = torch.tensor([j for j in range(bank[kind]) if j != out])
        order = torch.randperm(rest.numel(), generator=frames.generator(
            seed, 5, i, device="cpu"))
        items.append((kind, filt, rest[order][:depth[kind]]))
    return items


def inputs(config: dict, traffic: dict, seed: int, device,
           pool: int) -> MasterInputs:
    """The two banks on ``device`` and ``pool`` masters of the night."""
    geom = getattr(geometry, config["geometry"])
    a = config["assumed"]
    x = MasterInputs(_items(traffic, config["ncal_max"], seed, pool))
    x.bias_bank = _bias_bank(frames.generator(seed, 0, device=device),
                             geom.chan_shape, traffic["bias_bank"],
                             traffic["bias"], a["bias_read_noise_e"])
    x.flat_bank = _flat_bank(frames.generator(seed, 1, device=device), geom,
                             traffic["flat_bank"], traffic["flat"],
                             a["flat_level_e"])
    return x


class Entry:
    """A pool item -> its master and statistics."""

    def __init__(self, pkg: Package, config, traffic, inputs: MasterInputs,
                 device):
        self.masters = pkg.module("pipeline.masters")
        self.geom = pkg.geom(config)
        # null: the mosaic's central quarter, as the night's path takes it
        assert config["norm_sec"] is None
        self.banks = {"bias": inputs.bias_bank, "flat": inputs.flat_bank}

    def __call__(self, item) -> dict:
        kind, _, idx = item
        bank = self.banks[kind]
        master, stats = self.masters.build_master(
            kind, [bank[i] for i in idx.tolist()], self.geom)
        return {"master": master, "stats": stats}


def noise(master: torch.Tensor) -> torch.Tensor:
    """Each channel's robust noise, 1.4826 MAD on every 7th pixel, (C,)
    in float64."""
    v = master.reshape(master.shape[0], -1)[:, ::_SAMPLE].double()
    med = v.median(dim=1, keepdim=True).values
    return 1.4826 * (v - med).abs().median(dim=1).values


def _rel(got, want, scale) -> float:
    if got.shape != want.shape:
        return math.inf
    return float((compare.gap(got, want) / scale).max())


def numbers(got: dict, want: dict) -> dict:
    """``master_sigma``: the largest gap of the master, in units of the
    reference master's noise in the pixel's channel.  ``stats_rel``:
    the largest gap of the kind's statistics, relative: a bias's
    per-channel MBMEAN and MBSTD in units of the reference's MBSTD, a
    flat's ``medsec``, ``gaincf`` and ``mflat_med`` in units of the
    reference's own.  Statistics of another kind or shape read inf."""
    r = want["master"]
    sigma = _rel(got["master"], r, noise(r).clamp(min=1e-30)[:, None, None])
    gs, ws = got["stats"], want["stats"]
    if set(gs) != set(ws):
        rel = math.inf
    elif "medsec" in ws:
        rel = max(_rel(gs[k], ws[k], ws[k].double().abs().clamp(min=1e-30))
                  for k in ("medsec", "gaincf", "mflat_med"))
    else:
        std = ws["mbias_chan_std"].double().clamp(min=1e-30)
        rel = max(_rel(gs[k], ws[k], std)
                  for k in ("mbias_chan_mean", "mbias_chan_std"))
    return {"master_sigma": sigma, "stats_rel": rel}


def _cube(pkg: Package, change):
    """``pkg``'s ``stack_median`` on ``change(cube)``."""
    return faults.patched(pkg.module("pipeline.masters"), "stack_median",
                          lambda f: lambda cube: f(change(cube)))


def control(pkg: Package):
    """The cube that ``stack_median`` receives, held in bfloat16, the
    step below the configuration's float32."""
    return _cube(pkg, lambda c: c.to(torch.bfloat16).to(torch.float32))


def witness(pkg: Package):
    """That cube times (1 + 2**-23) in float32: a unit in the last
    place."""
    return _cube(pkg, lambda c: c * (1.0 + 2.0 ** -23))


def _build(pkg: Package, make):
    return faults.patched(pkg.module("pipeline.masters"), "build_master",
                          make)


def stale(pkg: Package):
    """A step that returns its state unchanged: each call hands on the
    previous call's master and statistics."""
    def make(f):
        held = []

        def build(*a, **k):
            held.append(f(*a, **k))
            return held.pop(0) if len(held) > 1 else held[0]
        return build
    return _build(pkg, make)


def altered_pixel(pkg: Package):
    """An answer altered where it is produced: one master pixel, by 100
    times its channel's noise."""
    def make(f):
        def build(*a, **k):
            master, stats = f(*a, **k)
            master = master.clone()
            c, h, w = master.shape
            master[c // 2, h // 3, w // 2] += 100 * noise(master)[c // 2]
            return master, stats
        return build
    return _build(pkg, make)


def dropped_frame(pkg: Package):
    """A frame left out: the master stacked from all but the last of its
    frames."""
    def make(f):
        def build(imgtype, frames_, *a, **k):
            return f(imgtype, frames_[:-1], *a, **k)
        return build
    return _build(pkg, make)


FAULTS = (stale, altered_pixel, dropped_frame)
