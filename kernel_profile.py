#!/usr/bin/env python3
"""Where the time of K1 (label propagation) and K6 (split-real FFT) goes
on one CUDA card.

    python3 kernel_profile.py

On the inputs of ``chip_smoke.py`` phase 2 (K1 on the thresholded 10560²
star field at 32 steps and on a |Scorr| > 6-like map at 48 steps, as
``extract_transients`` calls it; K6 forward and inverse on a 10752²
pair) it runs each wrapper call once under ``torch.profiler`` after a
warm-up, and prints every device kernel of the call with its time and
launches, and the call's time from CUDA events.  For K1 it also prints
how the work spreads over the frame: the share of set pixels, and for
32 x 32 tiles how many hold foreground (the work list of csrc/
labelprop.cu) and, with the halo of the call's steps around them, how
many hold any and how many steps each would run if it stopped when its
haloed tile is still, read from a global propagation (the blocks of
the previous design).  Every line carries the card's name and power limit.
Imports nothing of jax; needs a CUDA device.
"""

import sys

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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_label()
    print(card)
    from blackbox_tpu_torch import kernels
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import fft, labeling
    kernels.lib()

    H, W = MEERLICHT.red_shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    star = chip_smoke.star_mask(chip_smoke.star_field(H, W, gen))
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

    N = L = 10752
    fgen = torch.Generator(device="cuda").manual_seed(21)
    xr = torch.randn((N, L), generator=fgen, device="cuda")
    xi = torch.randn((N, L), generator=fgen, device="cuda")
    for inverse in (False, True):
        s = 1.0 / N if inverse else 1.0
        profile(lambda: fft.fft_cols_split(xr, xi, inverse, s),
                f"K6 fft_cols_split {N}x{L} "
                f"{'inverse' if inverse else 'forward'}", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
