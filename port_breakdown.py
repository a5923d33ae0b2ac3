#!/usr/bin/env python3
"""Where the time goes in the port's science path, on one CUDA card.

    python3 port_breakdown.py

Builds the scene of ``chip_smoke.py``'s timed science frames (MeerLICHT
frame from seed 12345 on the card, production context with the PSF
stages on, bench.py's 0.05 deg registration in 8 strips), runs one
warm-up frame, then one raw -> transient frame with a synchronised
timer around every stage function the pipeline modules call, then one
frame under ``torch.profiler``.  It prints the stage table (ms and
calls, nested stages indented under their caller), the device time by
kernel name (top 20) and the device busy share of the profiled frame,
each line with the card's name and power limit.  The stage timers add
a synchronise per call, so the stage sum exceeds an untimed frame.
Imports nothing of jax; needs a CUDA device.
"""

import collections
import functools
import sys
import time

import numpy as np
import torch

import chip_smoke

# module -> the stage functions it calls, timed where it looks them up
STAGES = {
    "blackbox_tpu_torch.pipeline.subtract": (
        "calibrate_detector", "extract_catalog", "psf_at",
        "measure_scaling_device", "warp_shift2pass", "zogy_subtract",
        "extract_transients"),
    "blackbox_tpu_torch.pipeline.reduce": (
        "gain_correct", "overscan_correct", "build_mask", "lacosmic",
        "xtalk_correct", "xtalk_correct_mosaic", "detect_trails",
        "fill_holes", "euler_count", "background_mesh", "mini2back",
        "detect_segments", "segment_catalog", "aperture_photometry",
        "build_psf", "psf_photometry"),
    "blackbox_tpu_torch.ops.zogy": (
        "fft2_split", "ifft2_split", "_otf_scr", "_kernel_sq_stamps"),
    "blackbox_tpu_torch.ops.transients": (
        "label_segments", "fused_detect", "gather_slot_windows"),
    "blackbox_tpu_torch.ops.cosmics": (
        "_detect_math", "_prescreen_seeds", "_windowed_pass", "_dense_pass",
        "gather_slot_windows", "_win_masked_median"),
}

_totals = collections.defaultdict(float)
_calls = collections.Counter()
_stack = []


def _timed(name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        key = "/".join(_stack + [name])
        _stack.append(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            _totals[key] += (time.perf_counter() - t0) * 1e3
            _calls[key] += 1
            _stack.pop()
    return run


def instrument():
    import importlib
    for mod_name, names in STAGES.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            setattr(mod, name, _timed(name, getattr(mod, name)))


def scene():
    """A callable running one raw -> transient frame of the timed
    scene."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.ops.warp import grid_shift_ranges
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    from blackbox_tpu_torch.pipeline.subtract import make_science_programs
    from blackbox_tpu_torch.synth.device import make_science_device

    geom = MEERLICHT
    ctx = ReduceContext.from_defaults(
        geom, "ML1", lac_params=LACosmicParams(strip_rows=176),
        det_params=DetectParams(max_sources=20000, label_iters=32))
    C, ych, xch = geom.chan_shape
    mgen = torch.Generator(device="cuda").manual_seed(99)
    mbias = 0.5 * torch.randn((C, ych, xch), generator=mgen, device="cuda")
    mflat = 1.0 + 0.02 * torch.randn((C, ych, xch), generator=mgen,
                                     device="cuda")
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEEDS[0])
    chan, osv, osh, _ = make_science_device(gen, geom, nstars=4000,
                                            ncosmics=800, trail=True,
                                            nsat=20)
    args = (osv, osh, mbias, mflat, None)
    front, _ = make_science_programs(ctx, xtalk)
    ref = chip_smoke.reference_products(ctx, front, chan, args)

    H, W = geom.red_shape
    th = np.deg2rad(0.05)
    ct, st = np.cos(th), np.sin(th)
    cy, cx, step = 0.5 * H, 0.5 * W, 32
    gy = np.arange(0, H + step, step, np.float64)
    gx = np.arange(0, W + step, step, np.float64)
    gyy, gxx = np.meshgrid(gy - cy, gx - cx, indexing="ij")
    sx = (cx + ct * gxx + st * gyy + 3.2).astype(np.float32)
    sy = (cy - st * gxx + ct * gyy - 2.7).astype(np.float32)
    rx = ref["cat"]["x"].double() - cx - 3.2
    ry = ref["cat"]["y"].double() - cy + 2.7
    cat = dict(ref["cat"], x=(cx + ct * rx - st * ry).float(),
               y=(cy + st * rx + ct * ry).float())
    front, back = make_science_programs(
        ctx, xtalk, remap_ranges=grid_shift_ranges(sy, sx, step=step,
                                                   blocks=8),
        remap_step=step)

    def run_frame():
        f = front(chan, *args)
        b = back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                 f["cat"], f["stats"]["bkg_std"], ref["sub"], ref["std"],
                 ref["mask"], (sy, sx), ref["psf"], ref["sr"], cat)
        torch.cuda.synchronize()
        return int(b["trans_stats"]["t_ntrans"])

    return run_frame


def main() -> int:
    if not torch.cuda.is_available():
        print("port_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_label()
    print(card)
    from blackbox_tpu_torch import kernels
    kernels.lib()
    run_frame = scene()
    run_frame()                                        # warm-up

    t0 = time.perf_counter()
    run_frame()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"untimed frame: {plain_ms:.1f} ms raw -> transient catalog "
          f"[{card}]")

    instrument()
    t0 = time.perf_counter()
    run_frame()
    timed_ms = (time.perf_counter() - t0) * 1e3
    print(f"stage-timed frame: {timed_ms:.1f} ms [{card}]")
    print("stage | ms | calls")
    for key in sorted(_totals, key=lambda k: (k.split("/")[0], k)):
        depth = key.count("/")
        print(f"{'  ' * depth}{key.split('/')[-1]} | {_totals[key]:.1f} | "
              f"{_calls[key]}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frame()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):       # the attribute's name moved across versions
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # the kernels themselves: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0]
    events.sort(key=lambda e: -device_us(e))
    busy_ms = sum(device_us(e) for e in events) / 1e3
    print(f"profiled frame: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms of "
          f"device time, busy share {busy_ms / wall_ms:.3f} [{card}]")
    print("device kernel | ms | launches")
    for e in events[:20]:
        print(f"{e.key[:90]} | {device_us(e) / 1e3:.1f} | {e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
