#!/usr/bin/env python3
"""Where the time of K1 (label propagation), K5 (fused detection), K6
(split-real FFT) and K7 (fused L.A.Cosmic) goes on one CUDA card.

    python3 kernel_profile.py [K1] [K5] [K6] [K7]     (all four if none)

On the inputs of ``chip_smoke.py`` (K1 on the thresholded 10560² star
field at 32 steps and on a |Scorr| > 6-like map at 48 steps, as
``extract_transients`` calls it; K5 in its detection and transient
forms, ``chip_smoke.detect_forms``; K6 forward and inverse on a 10752²
pair; K7 on the first call a science frame's calibration makes under
``LACosmicParams(use_pallas=True)``) it runs each wrapper call once
under ``torch.profiler`` after a warm-up, and prints every device
kernel of the call with its time and launches, and the call's time
from CUDA events.  For K1 it also prints how the work spreads over the
frame: the share of set pixels, and for 32 x 32 tiles how many hold
foreground (the work list of csrc/labelprop.cu) and, with the halo of
the call's steps around them, how many hold any and how many steps each
would run if it stopped when its haloed tile is still, read from a
global propagation (the blocks of the previous design).  For K5 the
same for the 64 x 64 blocks of its first design and the 32 x 32 tiles
its scan lists.  For K7, for each
iteration: the share of pixels whose cosmic mask crm2 is not 0 and
whose gt(sp, sigclip) is not 0, and the pixels the kernel listed for
the 7x7 median and for the masked clean.  Every line carries the card's
name and power limit.  Imports nothing of jax; needs a CUDA device.
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke


def profile(fn, label, card):
    """Each device kernel of one call of ``fn`` (after a warm one) with
    its time and launches, and the call's time from CUDA events."""
    times = chip_smoke.device_times(fn)
    total = sum(t for t, _ in times.values())
    print(f"{label}: {chip_smoke.cuda_ms(fn):.3f} ms from CUDA events, "
          f"{total:.3f} ms of device time under the profiler [{card}]")
    for name, (t, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name[:100]} | {t:.3f} ms | {n} launches")


def block_steps(lab, steps, tile=32):
    """The number of ``tile`` x ``tile`` tiles that hold foreground, the
    number whose ``steps``-wide halo does, and a histogram of the steps
    each would run if it stopped at the first step that leaves its
    haloed tile unchanged, read from a global propagation."""
    from blackbox_tpu_torch.ops.labeling import _label_propagate_plain
    H, W = lab.shape
    big = H * W + 2
    win, pad = tile + 2 * steps, steps

    def pooled(m):
        m = F.pad(m[None, None].float(), (pad, pad + tile, pad, pad + tile))
        p = F.max_pool2d(m, win, stride=tile)[0, 0]
        return p[:(H + tile - 1) // tile, :(W + tile - 1) // tile] > 0

    fg = lab < big
    listed = int((F.max_pool2d(fg[None, None].float(), tile,
                               stride=tile, ceil_mode=True) > 0).sum())
    fg_blocks = int(pooled(fg).sum())
    last = torch.full(pooled(fg).shape, -1, dtype=torch.int32,
                      device=lab.device)
    for s in range(steps):
        new = _label_propagate_plain(lab, 1)
        last = torch.where(pooled(new != lab), s, last)
        lab = new
    run = torch.clamp(last + 2, max=steps)
    return listed, fg_blocks, torch.bincount(run.reshape(-1).long(),
                                             minlength=steps + 1)


def k7_input():
    """The arguments of the first K7 call that a science frame's
    calibration makes under ``LACosmicParams(use_pallas=True)``: the
    raw frame of chip_smoke.py's first seed with its phase-3 masters."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,
                                                    calibrate_detector)
    from blackbox_tpu_torch.synth.device import make_science_device

    ctx = ReduceContext.from_defaults(
        MEERLICHT, "ML1",
        lac_params=LACosmicParams(strip_rows=176, use_pallas=True))
    C, ych, xch = MEERLICHT.chan_shape
    mgen = torch.Generator(device="cuda").manual_seed(99)
    mbias = 0.5 * torch.randn((C, ych, xch), generator=mgen, device="cuda")
    mflat = 1.0 + 0.02 * torch.randn((C, ych, xch), generator=mgen,
                                     device="cuda")
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEEDS[0])
    raw = make_science_device(gen, MEERLICHT, nstars=4000, ncosmics=800,
                              trail=True, nsat=20)[:3]
    run, first = K7._run_cuda, []

    def record(*args):
        first.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args[:7]))
        return run(*args)

    K7._run_cuda = record
    try:
        calibrate_detector(ctx, *raw, mbias, mflat, None, xtalk)
    finally:
        K7._run_cuda = run
    return first[0]


def k7_sp(clean, rdn, rows=1024):
    """sp = s - med5(s) of one K7 iteration on the (Hp, Wp) frame, from
    the plain version's pieces in row strips."""
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    Hp, _ = clean.shape
    P = K7.HALO
    ext = K7._edge(clean, P)
    out = torch.empty_like(clean)
    for r0 in range(0, Hp, rows):
        r1 = min(r0 + rows, Hp)
        c = ext[r0:r1 + 2 * P]
        m5 = torch.clamp(K7._median_edge(c, 5), min=1e-5)
        s = K7._laplacian(c) / (2.0 * torch.sqrt(m5 + rdn * rdn))
        out[r0:r1] = (s - K7._median_edge(s, 5))[P:-P, P:-P]
    return out


def profile_k5(card, img):
    """K5's two forms, and how their labels spread over 64 x 64 blocks
    (the first design) and over 32 x 32 tiles (the scan's work list)."""
    from blackbox_tpu_torch.ops import detection
    H, W = img.shape
    for form, (args, _, _) in chip_smoke.detect_forms(img).items():
        steps = args[5]
        profile(lambda: detection.fused_detect(*args[:5], iters=steps,
                                               absval=args[6]),
                f"K5 fused_detect {form} form {H}x{W} {steps} steps", card)
        det = detection._fused_detect_plain(*args[:5], 0, args[6])[0] > 0
        lab0 = chip_smoke.label_start(det)
        for tile in (64, 32):
            listed, fg, hist = block_steps(lab0, steps, tile)
            nblk = int(hist.sum())
            print(f"  {form} form ({float(det.float().mean()):.6f} of "
                  f"pixels detected), {tile}x{tile} tiles: {nblk}, "
                  f"{listed} hold a detection; with a {steps}-px halo {fg} "
                  f"do, {nblk - int(hist[1])} run more than one step; "
                  f"steps run: "
                  f"{ {i: int(c) for i, c in enumerate(hist.tolist()) if c} }"
                  f" [{card}]")
        del det, lab0


def profile_k7(card):
    """K7 on a science frame's first call, and for each iteration the
    shares of pixels that its two sparse stages must visit."""
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    args = k7_input()
    H, W = args[0].shape
    profile(lambda: K7.lacosmic_fused(*args),
            f"K7 lacosmic_fused {H}x{W}, {args[6]} iterations", card)
    data, inmask, rdn, sigclip, sigfrac, objlim, niter = args
    padded = K7.padded_shape(H, W)
    clean, crm = data, None
    inm = inmask.contiguous().view(torch.uint8)
    for it in range(niter):
        total = torch.zeros((), dtype=torch.int32, device="cuda")
        counts = torch.empty(2, dtype=torch.int32, device="cuda")
        out, crm = K7._iter_cuda(clean, inm, crm, rdn, sigclip, sigfrac,
                                 objlim, padded, total, counts)
        n = crm.numel()
        # the first iteration reads the unpadded frame: pad it as the
        # plain version does
        Hs, Ws = clean.shape
        Hp, Wp = padded
        c = F.pad(clean[None], (0, Wp - Ws, 0, Hp - Hs), mode="replicate")[0]
        hot = int((K7._gt(k7_sp(c, rdn), sigclip) != 0).sum())
        flagged = int((crm != 0).sum())
        n7, nc = counts.tolist()
        print(f"  K7 iteration {it} on {padded}: crm2 != 0 at "
              f"{flagged} pixels ({flagged / n:.3e}), gt(sp, sigclip) != 0 "
              f"at {hot} ({hot / n:.3e}); listed for the 7x7 median {n7} "
              f"of the extended domain, for the clean {nc} ({nc / n:.3e})"
              f" [{card}]")
        clean = out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    parts = set(sys.argv[1:]) or {"K1", "K5", "K6", "K7"}
    card = chip_smoke.card_label()
    print(card)
    from blackbox_tpu_torch import kernels
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import fft, labeling
    kernels.lib()

    H, W = MEERLICHT.red_shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    img = chip_smoke.star_field(H, W, gen)
    if "K1" in parts:
        star = chip_smoke.star_mask(img)
        tgen = torch.Generator(device="cuda").manual_seed(6)
        forms = (("star field", star, 32),
                 ("transient map", chip_smoke.transient_map(H, W, tgen), 48))
        for form, mask, steps in forms:
            lab0 = chip_smoke.label_start(mask)
            profile(lambda: labeling.label_propagate(lab0, steps),
                    f"K1 label_propagate {form} {H}x{W} {steps} steps "
                    f"({float(mask.float().mean()):.5f} of pixels set)", card)
            for s in sorted({min(steps, 32), steps}):
                listed, fg, hist = block_steps(lab0, s)
                nblk = int(hist.sum())
                print(f"  {form}, 32x32 tiles: {nblk}, {listed} hold "
                      f"foreground; with a {s}-px halo {fg} do, "
                      f"{nblk - int(hist[1])} "
                      f"run more than one step; steps run: "
                      f"{ {i: int(c) for i, c in enumerate(hist.tolist()) if c} }"
                      f" [{card}]")
            del lab0
        del star, forms
    if "K5" in parts:
        profile_k5(card, img)
    del img

    if "K6" in parts:
        N = L = 10752
        fgen = torch.Generator(device="cuda").manual_seed(21)
        xr = torch.randn((N, L), generator=fgen, device="cuda")
        xi = torch.randn((N, L), generator=fgen, device="cuda")
        for inverse in (False, True):
            s = 1.0 / N if inverse else 1.0
            profile(lambda: fft.fft_cols_split(xr, xi, inverse, s),
                    f"K6 fft_cols_split {N}x{L} "
                    f"{'inverse' if inverse else 'forward'}", card)
        del xr, xi
    if "K7" in parts:
        torch.cuda.empty_cache()
        profile_k7(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
