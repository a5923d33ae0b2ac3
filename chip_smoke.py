#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels are built from ``blackbox_tpu_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, bit for
   bit, at the main path's shapes: label propagation on a 10560² star
   field at 32 steps, the k = 3, 5, 7 medians of a 10560² frame, and
   20000 32² + 1024 96² window gathers from an f32 and an int32 frame
   with n_active < N.  Both times come from CUDA events.
3. The main path: the reduction (``make_reduce_fn``, production
   configuration, ``fit_psf=False``) of a TINY frame on the card held
   against the same frame reduced on the CPU with the plain versions,
   then of three full MeerLICHT frames made on the card from three
   seeds.  The kernels' launch counters are zeroed just before the
   full frames and must all have moved after them.
4. One JSON line with the kernels' counts and times, then the last
   line ``{"ok": true, "device": {...}}``.

Any failure raises: the script then exits non-zero and prints no ok
line.  It needs a CUDA device and the repository's port package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEEDS = (12345, 12346, 12347)
IMG_ATOL_REL = 1e-5     # image atol per e- of overscan level (see tests)


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device ms of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, NaN matching NaN; raises unless bit-identical."""
    both_nan = torch.isnan(a) & torch.isnan(b) if a.is_floating_point() \
        else torch.zeros_like(a, dtype=torch.bool)
    diff = torch.where(both_nan, 0, (a.double() - b.double()).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if err != 0.0 or bool((torch.isnan(a) != torch.isnan(b)).any()):
        raise AssertionError(f"kernel differs from its plain version: "
                             f"max |diff| = {err}")
    return err


def star_field(H, W, gen, nstars=4000, sky=300.0):
    """Moffat star field + sky + Gaussian noise (float32, on the card)."""
    from blackbox_tpu_torch.synth.device import moffat_kernel
    dev = gen.device
    delta = torch.zeros((H, W), device=dev)
    iy = torch.randint(0, H, (nstars,), generator=gen, device=dev)
    ix = torch.randint(0, W, (nstars,), generator=gen, device=dev)
    flux = torch.exp(torch.empty(nstars, device=dev).uniform_(
        np.log(2e3), np.log(2e5), generator=gen))
    delta.index_put_((iy, ix), flux, accumulate=True)
    img = torch.fft.irfft2(torch.fft.rfft2(delta)
                           * torch.fft.rfft2(moffat_kernel((H, W),
                                                           device=dev)),
                           s=(H, W))
    return img + sky + np.sqrt(sky) * torch.randn((H, W), generator=gen,
                                                   device=dev)


def check_kernels(card):
    """Phase 2: each kernel against its plain version at full shapes."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import filters, labeling, windows
    from blackbox_tpu_torch.ops.detection import matched_filter

    H, W = MEERLICHT.red_shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    img = star_field(H, W, gen)
    results = []

    # K1: the thresholded star field of the detection stage, 32 steps
    filt, _ = matched_filter(img - 300.0, 3.0)
    mask = filt > 1.5 * np.sqrt(300.0)
    del filt
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device="cuda").reshape(H, W)
    lab0 = torch.where(mask, idx, H * W + 2)
    err = max_abs_err(labeling.label_propagate(lab0, 32),
                      labeling._label_propagate_plain(lab0, 32))
    ms = cuda_ms(lambda: labeling.label_propagate(lab0, 32))
    plain = cuda_ms(lambda: labeling._label_propagate_plain(lab0, 32))
    print(f"K1 label_propagate {H}x{W} 32 steps ({float(mask.float().mean()):.4f}"
          f" of pixels set): bit-exact, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms [{card}]")
    results.append(dict(name="label_propagate",
                        source="blackbox_tpu_torch/csrc/labelprop.cu",
                        replaces="blackbox_tpu/pallas/labelprop.py:52",
                        max_abs_err=err, ms=ms, plain_ms=plain))
    seg = torch.where(mask, labeling.label_propagate(lab0, 32), 0)
    del lab0, idx, mask

    # K2: k = 3, 5, 7; the entry's times are one detection round's mix
    # (one 3x3, two 5x5, one 7x7 median)
    t, tp, err = {}, {}, 0.0
    for k in filters.MEDIAN_KS:
        err = max(err, max_abs_err(filters.median_filter(img, k),
                                   filters._median_plain(img, k, 264)))
        t[k] = cuda_ms(lambda: filters.median_filter(img, k))
        tp[k] = cuda_ms(lambda: filters._median_plain(img, k, 264), reps=1)
        print(f"K2 median_filter k={k} {H}x{W}: bit-exact, kernel "
              f"{t[k]:.3f} ms, plain {tp[k]:.3f} ms [{card}]")
    results.append(dict(name="median_filter",
                        source="blackbox_tpu_torch/csrc/medians.cu",
                        replaces="blackbox_tpu/pallas/medians.py:48",
                        max_abs_err=err, ms=t[3] + 2 * t[5] + t[7],
                        plain_ms=tp[3] + 2 * tp[5] + tp[7]))

    # K4: the catalog's small and big window gathers, n_active < N
    ms = plain = err = 0.0
    for N, size in ((20000, 32), (1024, 96)):
        y0 = torch.randint(-20, H + 20, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
        x0 = torch.randint(-20, W + 20, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
        nact = torch.tensor(N - N // 7, dtype=torch.int32, device="cuda")
        got = windows.gather_slot_windows((img, seg), y0, x0, size,
                                          n_active=nact)
        ref = windows._gather_plain((img, seg), y0, x0, size, nact)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, ref)))
        tk = cuda_ms(lambda: windows.gather_slot_windows(
            (img, seg), y0, x0, size, n_active=nact))
        tpl = cuda_ms(lambda: windows._gather_plain((img, seg), y0, x0,
                                                    size, nact))
        ms, plain = ms + tk, plain + tpl
        print(f"K4 gather_slot_windows {N}x{size}^2 (f32 + int32, "
              f"n_active {int(nact)}): bit-exact, kernel {tk:.3f} ms, "
              f"plain {tpl:.3f} ms [{card}]")
    results.append(dict(name="gather_slot_windows",
                        source="blackbox_tpu_torch/csrc/gather.cu",
                        replaces="blackbox_tpu/pallas/gather.py:61",
                        max_abs_err=err, ms=ms, plain_ms=plain))
    return results


def check_outputs(out, ctx, label):
    """Finite image/stats/catalog of the expected shapes."""
    H, W = ctx.geom.red_shape
    if out["image"].shape != (H, W) or out["mask"].shape != (H, W):
        raise AssertionError(f"{label}: wrong output shapes")
    if not bool(torch.isfinite(out["image"]).all()):
        raise AssertionError(f"{label}: non-finite image pixels")
    for k, v in out["stats"].items():
        if not bool(torch.isfinite(v.double()).all()):
            raise AssertionError(f"{label}: stat {k} is not finite")
    valid = out["cat"]["valid"]
    for k in ("x", "y", "flux_ap", "fluxerr_ap", "fwhm"):
        if not bool(torch.isfinite(out["cat"][k][valid]).all()):
            raise AssertionError(f"{label}: catalog {k} not finite")


def check_tiny(reduce_ctx_for, card):
    """The port on the card (kernels) against the port on the CPU (plain
    versions) for one TINY frame: masks, labels and counts exact, float
    planes to the f32 rounding of the overscan level."""
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.pipeline.reduce import make_reduce_fn
    from blackbox_tpu_torch.synth.device import make_science_device

    ctx = reduce_ctx_for(TINY)
    gen = torch.Generator().manual_seed(3)
    chan, osv, osh, _ = make_science_device(gen, TINY, nstars=40,
                                            ncosmics=12, nsat=2)
    C, ych, xch = TINY.chan_shape
    mflat = (1.0 + 0.02 * torch.randn((C, ych, xch), generator=gen)).numpy()
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)
    fn = make_reduce_fn(ctx)
    cpu = fn(chan, osv, osh, None, mflat, None, xtalk)
    gpu = fn(chan.cuda(), osv.cuda(), osh.cuda(), None, mflat, None, xtalk)
    torch.cuda.synchronize()
    check_outputs(gpu, ctx, "TINY")
    for k in ("mask", "seg_nsources"):
        if not torch.equal(cpu[k], gpu[k].cpu()):
            raise AssertionError(f"TINY: {k} differs between card and CPU")
    for k in ("nobjects", "ncosmics", "nsats", "nobj_sat"):
        if int(cpu["stats"][k]) != int(gpu["stats"][k]):
            raise AssertionError(f"TINY: {k} differs between card and CPU")
    atol = 1e-3 + IMG_ATOL_REL * float(cpu["stats"]["biasm"].abs().max())
    for k in ("image", "bkg", "bkg_std"):
        d = float((cpu[k] - gpu[k].cpu()).abs().max())
        if d > atol + 1e-5 * float(cpu[k].abs().max()):
            raise AssertionError(f"TINY: {k} differs by {d} e-")
    print(f"TINY frame on the card vs the CPU plain path: mask, labels and "
          f"counts equal (nobjects {int(gpu['stats']['nobjects'])}), image "
          f"max |diff| {float((cpu['image'] - gpu['image'].cpu()).abs().max()):.3g}"
          f" e- [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # phase 1: device and build
    card = card_label()
    print(card)
    from blackbox_tpu_torch import kernels
    t0 = time.time()
    kernels.lib()
    print(f"built the CUDA kernels in {time.time() - t0:.1f} s")

    # phase 2: kernels against their plain versions
    results = check_kernels(card)
    torch.cuda.empty_cache()

    # phase 3: the main path
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import filters, labeling, windows
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,
                                                    make_reduce_fn)
    from blackbox_tpu_torch.synth.device import make_science_device

    def ctx_for(geom):
        return ReduceContext.from_defaults(
            geom, "ML1", lac_params=LACosmicParams(strip_rows=176),
            det_params=DetectParams(max_sources=20000, label_iters=32),
            fit_psf=False)

    check_tiny(ctx_for, card)

    geom = MEERLICHT
    ctx = ctx_for(geom)
    fn = make_reduce_fn(ctx)
    C, ych, xch = geom.chan_shape
    mgen = torch.Generator(device="cuda").manual_seed(99)
    mbias = 0.5 * torch.randn((C, ych, xch), generator=mgen, device="cuda")
    mflat = 1.0 + 0.02 * torch.randn((C, ych, xch), generator=mgen,
                                     device="cuda")
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)
    counters = (labeling.label_propagate, filters.median_filter,
                windows.gather_slot_windows)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    frame_ms = []
    for i, seed in enumerate(SEEDS):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        chan, osv, osh, _ = make_science_device(
            gen, geom, nstars=4000, ncosmics=800, trail=True, nsat=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(chan, osv, osh, mbias, mflat, None, xtalk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_outputs(out, ctx, f"frame {i}")
        st = out["stats"]
        nobj, ncr, nsat = (int(st["nobjects"]), int(st["ncosmics"]),
                           int(st["nsats"]))
        print(f"frame {i} (seed {seed}{', warm-up' if i == 0 else ''}): "
              f"{ms:.1f} ms, nobjects {nobj}, ncosmics {ncr}, nsats {nsat}, "
              f"seeing {float(st['s_seeing_pix']):.2f} px [{card}]")
        if not 3000 <= nobj <= 5000:
            raise AssertionError(f"frame {i}: nobjects {nobj} outside "
                                 "3000..5000 (4020 sources injected)")
        if ncr <= 0 or nsat < 1:
            raise AssertionError(f"frame {i}: ncosmics {ncr}, nsats {nsat}")
        frame_ms.append(ms)
        del out, chan, osv, osh
    launches = {c.__name__: c.launches for c in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = frame_ms[1:]
    print(f"main path: {sum(steady) / len(steady):.1f} ms/frame steady "
          f"(frames {', '.join(f'{m:.1f}' for m in steady)} ms after a "
          f"{frame_ms[0]:.1f} ms warm-up), peak memory {peak_gib:.2f} GiB, "
          f"launches {launches} [{card}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")

    for r in results:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
