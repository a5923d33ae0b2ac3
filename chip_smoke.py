#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels are built from ``blackbox_tpu_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, bit for
   bit, at the main paths' shapes: label propagation (K1) on a 10560²
   star field at 32 steps and on a |Scorr| > 6-like map at 48 steps
   (``extract_transients``' form), the k = 3, 5, 7 medians (K2) of a
   10560² frame and of a copy with 1e-4 of its pixels NaN, 20000 32² +
   1024 96² window gathers (K4) from an f32 and an int32 frame with
   n_active < N, the split-real FFT (K6) of a 10752 x 10752 pair
   forward and inverse (each pass's two launches, step A and radix-2,
   timed apart under ``torch.profiler``), and the fused detection (K5)
   in its detection form (the star field, 9 taps, a std map, an
   exclusion, 32 steps) and its transient form (|x|, no taps, 48
   steps).  Both times come from CUDA events; each kernel's bound is
   worked out from the bytes it must move and the operations it must
   do at those shapes (``bound``; K4's for each of its two calls).
   The times of K1's, K5's, K6's and K7's previous designs are printed
   beside theirs (``PREVIOUS_MS``).
3. The reduction (``make_reduce_fn``, production configuration with the
   PSF stages on) of a TINY frame on the card held against the same
   frame reduced on the CPU with the plain versions, then of three full
   MeerLICHT frames made on the card from three seeds.
4. The science path (``make_science_programs``): the reference products
   from seed 12345, then a timed scene (bench.py's registration: 0.05
   deg rotation, offset (3.2, -2.7), 8 strips) of one warm-up and two
   raw -> transient frames, and a gated scene (the reference rolled by
   the integer shift (3, -2), 20 PSF-shaped transients injected into
   the new raw frame) run without and then with BBTPU_PALLAS_DETECT=1,
   which must give the same catalog bit for bit.
5. A calibration night, then the reduction under
   ``LACosmicParams(use_pallas=True)``: 3 bias-like and 3 flat-like raw
   frames calibrated as the driver calibrates calibration frames (no
   crosstalk, non-linearity on, K7 in L.A.Cosmic), the master bias,
   master flat (GAINCF) and flat statistics, then two science frames
   reduced with those masters through K7, and each frame's two
   background planes made again by ``mini2back(..., use_pallas=True)``
   (K3, which no reduction calls) against the reduction's own.
6. After phase 5's counted run: its first science frame reduced again
   with the default L.A.Cosmic (the two cosmic masks must agree to a
   Jaccard index of 0.9), then K7 and K3 against their plain versions,
   bit for bit, on the inputs that frame gave them: K7 over 3
   iterations on the whole calibrated 10560² mosaic, mask and read
   noise the reduction passed it, K3 on the frame's two 41 x 41
   background meshes to 10560² (beside ``torch.linalg.multi_dot``).
7. File to file through the port's driver (``pipeline/driver.Pipeline
   .process_file``).  First the TINY night of
   ``tests/test_torch_driver.py`` (3 bias, 3 flat, 2 visits of field
   42, the first adopted as the field reference, the second with a
   transient) on the card and again on the CPU (plain versions), held
   together by ``tests/night_parity.py`` (statuses, products, keywords
   and flags, masks bit for bit, images, catalogs and transients at
   the tier-1 parity tolerances).  Then a full MeerLICHT night of the
   same sequence, raw uint16 FITS made on the card (``night_phase``;
   the visits without a satellite trail, which would send them to QC
   red through a fault the port matches),
   reduced file to file: every frame reduced, masters built and
   applied, astrometry and photometric calibration, the first visit
   adopted as the reference, the second subtracted (``run_subtraction``
   on the two-pass remap: its pointing is a few pixels off) with at
   least 16 of its 20 injected transients in the published catalog and
   Z-FRATIO within 5% of the true 1.25, the compiled Rice coder in use.
   One line a frame: wall, device (the synchronised calibration +
   extraction and subtraction spans) and host ms; peak memory and the
   phase's seconds.
8. The reference co-add, in phase 7's tree and night
   (``coadd_phase``): a third visit of field 42 (new noise and cosmics,
   dithered COADD_DITHER px and rotated COADD_ROT deg) through
   ``process_file(..., trans_extract=False)``; then the command line,
   ``main(["--buildref", "42", ...])``, over the three visits at full
   width (the blocked combiner: 3 x 1.338e9 B is over its 4e9-byte
   switch).  Against the adopted single frame it must print
   ``not_deeper`` and return 0: the reference states the co-add's
   LIMMAG for an exposure of 1 s, the frame's for its 60 s (a fault the
   port matches, ROADMAP Queue 3); the co-add must be 0.1 mag deeper
   once that is counted.  Then ``build_reference`` with
   BuildRefSettings(nimages_min=3, limmag_target=30, seeing_max=10),
   the pipeline's context for the catalog and PSF, and the gate lowered
   by 2.5 log10(60): it must publish (NIMAGES 3, the single frame under
   ``ref-old/``, K1 and K4 launched by its catalog and PSF), with a
   median background STD below every input's and visit 2's transients
   clipped at their cores outside the saturation protection; the loads
   (``load_ref_input``) and the combiner (``instrument=True``: prep,
   upload, compute and drain) are timed.  Then the resident
   ``coadd_field`` on the same inputs against the blocked co-add, and
   the full-res std planes against the mini-mesh std source
   (``compare_coadds``: tests/test_coadd.py's contract, widened by the
   float32 rounding of full-width coordinates), and a fourth visit with
   NTRANS new transients subtracted against the co-add: at least 16
   found, Z-FRATIO within 5% of 1.25.
9. One JSON line with the kernels' counts and times (K4's with the
   time of the same gathers by advanced indexing, ``library_ms``), then
   the last line ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before each of phases 3, 4, 5, 7's
full night and 8 and read just after it: every kernel of a phase's path
must have moved, K1 must show 1 launch per catalog frame and 2 per
science frame (its 48 transient steps are one launch), K6 6 per science
frame, K7 3 per frame it calibrates (it counts iterations, four CUDA
launches each) and K2 none in phase 5; the night must show K1 3 times
(two catalogs, one subtraction) and K6 6 times, phase 8 K6 6 times
(one subtraction).  Any failure raises:
the script then exits non-zero and prints no ok line.
It needs a CUDA device and the repository's port package, and the
``tests/night_parity.py`` helper beside it.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEEDS = (12345, 12346, 12347)
IMG_ATOL_REL = 1e-5     # image atol per e- of overscan level (see tests)
# one H100 SXM, NVIDIA's data sheet and Hopper white paper: the HBM3
# rate; 128 float32 lanes an SM, so 33.5e12 float32 instructions a
# second (the sheet's 67 TFLOP/s counts an FMA as two flops; a min, a
# max, a multiply or an add is one instruction); 64 int32 lanes an SM
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 33.5e12
I32_INSTR_PER_S = 16.75e12
# The previous designs of K1 (one haloed tile a block, every step over
# the whole tile, at most 32 steps a launch), K6 (step A with its
# constants in shared memory, nine shared-memory passes of radix-2), K5
# (one 64² tile a block with an `iters`-wide halo, filtered and swept
# whole) and K7 (every stage at every pixel, five launches an
# iteration) on one H100 80GB HBM3 at 700 W, printed beside this run's
# (PERF.md §6): K1 on the star field (chip_smoke.py) and on the
# transient map, K6's passes and each pass's two launches
# (kernel_profile.py), K5's two forms and K7's 3 iterations
# (chip_smoke.py)
PREVIOUS_MS = {"K1 star field": 6.152, "K1 transient map": 3.538,
               "K6 forward": 3.479, "K6 inverse": 3.441,
               "K6 forward step A": 1.123, "K6 forward radix-2": 2.329,
               "K6 inverse step A": 1.156, "K6 inverse radix-2": 2.290,
               "K5 detection": 15.181, "K5 transient": 9.685,
               "K7": 52.781}
FRATIO = 1.3            # the reference is made 1.3x deeper (bench.py)
NTRANS = 20             # transients injected into the gated scene


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


def device_times(fn):
    """Device ms by kernel name of one call of ``fn`` after a warm one,
    from torch.profiler; empty if the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def bound(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    """The least time the card could take for the work, in ms, and what
    bounds it: the bytes moved at the HBM rate against the operations
    at their instruction rates.  Operations count instructions: an
    unfused min, max, multiply or add is one (the kernels contract no
    FMA)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_INSTR_PER_S + i32_ops / I32_INSTR_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by,
          library_ms=None):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


def star_mask(img):
    """The detection stage's threshold of a star field: the 3 px matched
    filter above 1.5 sigma of the 300 e- sky."""
    from blackbox_tpu_torch.ops.detection import matched_filter
    filt, _ = matched_filter(img - 300.0, 3.0)
    return filt > 1.5 * np.sqrt(300.0)


def transient_map(H, W, gen, nblobs=40, sigma=2.0):
    """A |Scorr| > 6 map as extract_transients thresholds it: unit noise
    plus ``nblobs`` Gaussian blobs of either sign, peaks 8..60 sigma."""
    dev = gen.device
    scorr = torch.randn((H, W), generator=gen, device=dev)
    r = 4 * int(np.ceil(sigma))
    ys = torch.randint(r, H - r, (nblobs,), generator=gen, device=dev)
    xs = torch.randint(r, W - r, (nblobs,), generator=gen, device=dev)
    amp = torch.empty(nblobs, device=dev).uniform_(8.0, 60.0, generator=gen)
    amp = torch.where(torch.rand(nblobs, generator=gen, device=dev) < 0.5,
                      amp, -amp)
    d = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    g = torch.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / (2 * sigma ** 2))
    for y, x, a in zip(ys.tolist(), xs.tolist(), amp.tolist()):
        scorr[y - r:y + r + 1, x - r:x + r + 1] += a * g
    return scorr.abs() > 6.0


def label_start(mask):
    """The labels label_components starts from: flat index + 1 on the
    mask, BIG = H*W + 2 elsewhere."""
    H, W = mask.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=mask.device).reshape(H, W)
    return torch.where(mask, idx, H * W + 2)


def check_kernels(card):
    """Phase 2: each kernel against its plain version at full shapes."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import filters, labeling, windows

    H, W = MEERLICHT.red_shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    img = star_field(H, W, gen)
    results = []

    # K1 in the two forms of the main paths: the thresholded star field
    # of the detection stage at 32 steps, and a |Scorr| > 6 map at 48,
    # as extract_transients calls it; the entry's times are the star
    # field's, the transient form's are under transient_*
    mask = star_mask(img)
    lab0 = label_start(mask)
    tgen = torch.Generator(device="cuda").manual_seed(6)
    k1 = {}
    for form, lab, steps in (("star field", lab0, 32),
                             ("transient map",
                              label_start(transient_map(H, W, tgen)), 48)):
        err = max_abs_err(labeling.label_propagate(lab, steps),
                          labeling._label_propagate_plain(lab, steps))
        ms = cuda_ms(lambda: labeling.label_propagate(lab, steps))
        plain = cuda_ms(lambda: labeling._label_propagate_plain(lab, steps),
                        reps=1)
        nfg = int((lab < H * W + 2).sum())
        # int32 labels in and out; 8 mins a step for each foreground pixel
        bnd = bound(8.0 * H * W, i32_ops=8.0 * steps * nfg)
        k1[form] = (err, ms, plain, bnd)
        print(f"K1 label_propagate {form} {H}x{W} {steps} steps "
              f"({nfg / (H * W):.6f} of pixels set): bit-exact, kernel "
              f"{ms:.3f} ms (previous design: "
              f"{PREVIOUS_MS['K1 ' + form]:.3f}), plain {plain:.3f} ms, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    err, ms, plain, bnd = k1["star field"]
    t_err, t_ms, t_plain, t_bnd = k1["transient map"]
    results.append(dict(entry("label_propagate",
                              "blackbox_tpu_torch/csrc/labelprop.cu",
                              "blackbox_tpu/pallas/labelprop.py:52",
                              max(err, t_err), ms, plain, *bnd),
                        transient_ms=t_ms, transient_plain_ms=t_plain,
                        transient_bound_ms=t_bnd[0]))
    seg = torch.where(mask, labeling.label_propagate(lab0, 32), 0)
    del lab0, mask

    # K2: k = 3, 5, 7, on the star field and on a copy with 1e-4 of its
    # pixels NaN; the entry's times are one detection round's mix (one
    # 3x3, two 5x5, one 7x7 median)
    t, tp, tb, err = {}, {}, {}, 0.0
    holes = img.clone()
    holes[torch.rand((H, W), generator=gen, device="cuda") < 1e-4] = np.nan
    th, tw = filters.MEDIAN_TILE
    for k in filters.MEDIAN_KS:
        for frame in (img, holes):
            err = max(err, max_abs_err(filters.median_filter(frame, k),
                                       filters._median_plain(frame, k, 264)))
        t[k] = cuda_ms(lambda: filters.median_filter(img, k))
        tp[k] = cuda_ms(lambda: filters._median_plain(img, k, 264), reps=1)
        # per pixel: the min/max of the tile program the kernel runs; f32
        # in and out.  The design it replaced: a column sort and the
        # pruned sorted-column merge
        ops, _, _ = filters.tile_median_ops(k, th, tw)
        per_px = filters.comparator_cost(ops) / (th * tw)
        merge, _ = filters.sc_select_ops(k, (k * k // 2,))
        old_px = (2 * len(filters.transposition_pairs(k))
                  + filters.comparator_cost(merge))
        tb[k] = bound(8.0 * H * W, f32_ops=per_px * H * W)
        print(f"K2 median_filter k={k} {H}x{W} (and with "
              f"{int(torch.isnan(holes).sum())} NaN pixels): bit-exact, "
              f"kernel {t[k]:.3f} ms, plain {tp[k]:.3f} ms, bound "
              f"{tb[k][0]:.3f} ms ({tb[k][1]}; {per_px:g} min/max a pixel, "
              f"{old_px} in the sorted-column design) [{card}]")
    del holes
    mix = (3, 5, 5, 7)
    results.append(entry(
        "median_filter", "blackbox_tpu_torch/csrc/medians.cu",
        "blackbox_tpu/pallas/medians.py:48", err, sum(t[k] for k in mix),
        sum(tp[k] for k in mix), sum(tb[k][0] for k in mix),
        "operations" if any(tb[k][1] == "operations" for k in mix)
        else "bytes"))

    # K4: the catalog's small and big window gathers, n_active < N
    ms = plain = err = nbytes = lib = 0.0
    call_bounds, call_library = [], []
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
        # the library's form of the same gathers: advanced indexing of
        # each frame on precomputed, clamped (N, S, S) index grids
        # (every slot, in-frame only: no fill, no n_active)
        ar = torch.arange(size, device="cuda")
        iy = (y0[:, None, None] + ar[None, :, None]).clamp(0, H - 1)
        ix = (x0[:, None, None] + ar[None, None, :]).clamp(0, W - 1)
        tlib = cuda_ms(lambda: (img[iy, ix], seg[iy, ix]))
        del iy, ix
        lib += tlib
        call_library.append(tlib)
        ms, plain = ms + tk, plain + tpl
        # 8 B a window pixel (f32 + int32): read for the live slots,
        # written for every slot
        call_bytes = 8.0 * size * size * (int(nact) + N)
        nbytes += call_bytes
        cb = bound(call_bytes)
        call_bounds.append(cb[0])
        print(f"K4 gather_slot_windows {N}x{size}^2 (f32 + int32, "
              f"n_active {int(nact)}): bit-exact, kernel {tk:.3f} ms, "
              f"plain {tpl:.3f} ms, library (frame[iy, ix] of both frames) "
              f"{tlib:.3f} ms, bound {cb[0]:.4f} ms ({cb[1]}; "
              f"{cb[0] / tk:.0%} of the kernel's time) [{card}]")
    results.append(dict(entry("gather_slot_windows",
                              "blackbox_tpu_torch/csrc/gather.cu",
                              "blackbox_tpu/pallas/gather.py:61", err, ms,
                              plain, *bound(nbytes), library_ms=lib),
                        call_bound_ms=call_bounds,
                        call_library_ms=call_library))
    results.append(check_fft(card))
    results.append(check_detect(card, img))
    return results


def dft_ops(N2: int) -> int:
    """Float instructions of one column's DFT_N2 in csrc/fft.cu: output
    0's terms at 8 each (4 products, 2 adds, 2 into the sums), then for
    each pair of outputs and input, 16 for two terms of their own, 10
    for one shared term and 12 for shared products
    (ops/fft.py::dft_pair_masks; the same counts both ways)."""
    from blackbox_tpu_torch.ops.fft import dft_pair_masks
    ops = 8 * N2
    for m in dft_pair_masks(N2, False):
        for j in range(1, N2 // 2 + 1):
            ops += 12 if m >> j & 1 else 10 if m >> (16 + j) & 1 else 16
    return ops


def check_fft(card):
    """K6 at the science path's shape: one (10752, 10752) column pass
    forward and one inverse with scale 1/N (the entry's times are the
    mean of the two), against the plain version and torch.fft."""
    from blackbox_tpu_torch.ops import fft

    N = L = 10752
    gen = torch.Generator(device="cuda").manual_seed(21)
    xr = torch.randn((N, L), generator=gen, device="cuda")
    xi = torch.randn((N, L), generator=gen, device="cuda")
    N1, N2, k = fft.plan(N)
    ms, plain, err = [], [], 0.0
    for inverse in (False, True):
        s = 1.0 / N if inverse else 1.0
        got = fft.fft_cols_split(xr, xi, inverse, s)
        ref = fft._fft_cols_plain(xr, xi, inverse, s)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, ref)))
        del got, ref
        ms.append(cuda_ms(lambda: fft.fft_cols_split(xr, xi, inverse, s)))
        plain.append(cuda_ms(lambda: fft._fft_cols_plain(xr, xi, inverse,
                                                          s), reps=1))
        way = "inverse" if inverse else "forward"
        print(f"K6 fft_cols_split {N}x{L} (N1 {N1}, N2 {N2}) {way}: "
              f"bit-exact, kernel {ms[-1]:.3f} ms (previous design: "
              f"{PREVIOUS_MS['K6 ' + way]:.3f}), plain {plain[-1]:.3f} ms "
              f"[{card}]")
    # each pass's two launches apart, from one profiled call of each
    split = device_times(lambda: (fft.fft_cols_split(xr, xi),
                                  fft.fft_cols_split(xr, xi, True, 1.0 / N)))
    launch_ms = {}
    for name, (t, n) in split.items():
        if "step_a" not in name and "radix2" not in name:
            continue
        way = ("inverse" if "step_a_inv" in name or "<true" in name
               else "forward")
        part = "step A" if "step_a" in name else "radix-2"
        launch_ms[f"{way} {part}"] = t / n
    for key in ("forward step A", "forward radix-2", "inverse step A",
                "inverse radix-2"):
        got = (f"{launch_ms[key]:.3f} ms" if key in launch_ms
               else "not measured (no device events)")
        print(f"K6 {key} launch: {got} (previous design: "
              f"{PREVIOUS_MS['K6 ' + key]:.3f}) [{card}]")
    lib = cuda_ms(lambda: torch.fft.fft(torch.complex(xr, xi), dim=0))
    # two planes in, two out; step A: the DFT_N2's instructions a
    # point, as the kernel shares them (dft_ops), and a twiddle; then k
    # radix-2 stages of an add/sub and a twiddle per point
    pts = float(N) * L
    ops = pts * (dft_ops(N2) / N2 + 6.0) + pts * k * 8.0
    bnd = bound(16.0 * pts, f32_ops=ops)
    print(f"K6 library torch.fft.fft of the same {N}x{L} pair: {lib:.3f} ms"
          f"; bound {bnd[0]:.3f} ms ({bnd[1]}) per pass [{card}]")
    return dict(entry("fft_cols_split", "blackbox_tpu_torch/csrc/fft.cu",
                      "blackbox_tpu/pallas/fft.py:164", err, sum(ms) / 2,
                      sum(plain) / 2, *bnd, library_ms=lib),
                forward_ms=ms[0], inverse_ms=ms[1], launch_ms=launch_ms)


def detect_forms(img):
    """K5's two forms on the star field ``img``, by name: the arguments
    of ``_fused_detect_plain`` (image, std, exclusion, taps, nsigma,
    steps, |x|), the bytes a pixel the call must move and the filter's
    float operations a pixel.  The detection form thresholds the
    filtered star field against a std map with a 10% spread; the
    transient form thresholds |x| of the star field in sigma units,
    as ``extract_transients`` thresholds Scorr; both exclude 1e-3 of
    the pixels and the first 64 rows."""
    from blackbox_tpu_torch.ops import detection

    H, W = img.shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    sub = img - 300.0
    std = np.sqrt(300.0) * (1.0 + 0.1 * torch.rand((H, W), generator=gen,
                                                    device="cuda"))
    excl = torch.rand((H, W), generator=gen, device="cuda") > 0.999
    excl[:64] = True
    taps = detection.gaussian_taps(3.0)
    scorr = sub / np.sqrt(300.0)
    return {"detection": ((sub, std, excl, taps, 1.5, 32, False),
                          13.0, 2 * 2 * len(taps)),
            "transient": ((scorr, None, excl, None, 6.0, 48, True),
                          9.0, 0)}


def check_detect(card, img):
    """K5 in both forms at 10560²: the detection form on the star field
    and the transient form on a Scorr-like map (the entry's times are
    the sum of one of each, as a science frame runs them under
    BBTPU_PALLAS_DETECT=1)."""
    from blackbox_tpu_torch.ops import detection

    H, W = img.shape
    forms = detect_forms(img)
    ms = plain = bnd_ms = err = 0.0
    bound_by = "bytes"
    forms_ms = {}
    for form, (args, bpp, flops) in forms.items():
        got = detection.fused_detect(*args[:5], iters=args[5],
                                     absval=args[6])
        ref = detection._fused_detect_plain(*args)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, ref)))
        nfg = int((got[0] > 0).sum())
        del got, ref
        tk = cuda_ms(lambda: detection.fused_detect(*args[:5], iters=args[5],
                                                    absval=args[6]))
        tpl = cuda_ms(lambda: detection._fused_detect_plain(*args), reps=1)
        # bytes a pixel: the image, std (f32) and exclusion (int8) read
        # once, the int32 segment map written once; the filter's
        # multiply-adds on every pixel, 8 mins a step on the detections
        b = bound(bpp * H * W, f32_ops=flops * H * W,
                  i32_ops=8.0 * args[5] * nfg)
        ms, plain, bnd_ms = ms + tk, plain + tpl, bnd_ms + b[0]
        bound_by = b[1] if b[1] == "operations" else bound_by
        forms_ms[form] = tk
        print(f"K5 fused_detect {form} form {H}x{W} ({args[5]} steps, "
              f"{nfg} pixels detected): bit-exact, kernel {tk:.3f} ms "
              f"(previous design: {PREVIOUS_MS['K5 ' + form]:.3f}), plain "
              f"{tpl:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) [{card}]")
    return dict(entry("fused_detect", "blackbox_tpu_torch/csrc/detect.cu",
                      "blackbox_tpu/pallas/detect.py:64", err, ms, plain,
                      bnd_ms, bound_by),
                detection_ms=forms_ms["detection"],
                transient_ms=forms_ms["transient"])


def k7_ops():
    """Float operations of csrc/lacosmic.cu: (dense per pixel and
    iteration, per pixel listed for the 7x7 median, per pixel listed for
    the masked clean, dense per pixel and iteration of the first design,
    which ran every stage at every pixel).  Stages 1 and 2 take their
    5x5 and 3x3 medians from K2's tile programs (the min/max of
    ``tile_median_ops`` over the tile's pixels); stage 1 adds the
    Laplacian and noise model, stage 2 sp and its gt test, then the two
    dilations and their gt tests; a listed 7x7 median runs the
    sorted-column network (a column sort, one column a pixel, and the
    pruned merge) and adds f and the seed mask's second gt test, a
    listed clean the 25-value transposition sort, the blend and good
    count, and the two 25-term rank picks.  The first design ran the
    sorted-column network for every median."""
    from blackbox_tpu_torch.ops.filters import (MEDIAN_TILE,
                                                comparator_cost,
                                                sc_select_ops,
                                                tile_median_ops,
                                                transposition_pairs)

    def median(k):
        merge, _ = sc_select_ops(k, (k * k // 2,))
        return 2 * len(transposition_pairs(k)) + comparator_cost(merge)

    def tile(k):
        ops, _, _ = tile_median_ops(k, *MEDIAN_TILE)
        return comparator_cost(ops) / (MEDIAN_TILE[0] * MEDIAN_TILE[1])

    rest1 = 24                               # lap 17, noise 2, s 2, clamp
    rest2 = 7                                # sp, gt(sp, sigclip), good, c1
    grow = 9 + 25 + 2 * 7 + 1                # two dilations, gts, max
    med7 = median(7) + 13                    # noise, f, gt(sp / f), c1
    clean = 2 * len(transposition_pairs(25)) + 25 * 6 + 25 * 2 * 6 + 16
    dense = tile(5) + tile(3) + rest1 + tile(5) + rest2 + grow
    first = (median(5) + median(3) + rest1 + median(5) + rest2 + grow
             + med7 + clean)
    return float(dense), float(med7), float(clean), float(first)


def check_k7(card, args):
    """K7 on the call the reduction made in phase 5 (``args``: the
    calibrated mosaic, its mask, read noise, sigclip, sigfrac, objlim
    and niter), bit-exact against its plain version at that full shape
    and timed there.  Its bound counts the operations these inputs need
    (the dense stages everywhere, the 7x7 median and the clean on the
    pixels the kernel listed); the bound of the same call at the design
    that ran every stage everywhere is printed beside it."""
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    H, W = args[0].shape
    niter = args[6]
    got = K7._run_cuda(*args)
    listed = [tuple(c) for c in got[3].tolist()]
    ref = K7._lacosmic_plain(*args)
    err = max(max_abs_err(a, b) for a, b in zip(got[:3], ref))
    nflag = int(got[1].sum())
    if nflag <= 0:
        raise AssertionError("K7: no cosmic pixel flagged")
    del got, ref
    ms = cuda_ms(lambda: K7.lacosmic_fused(*args))
    plain = cuda_ms(lambda: K7._lacosmic_plain(*args), reps=1)
    Hp, Wp = K7.padded_shape(H, W)
    dense, med7, clean, first = k7_ops()
    n7 = sum(c[0] for c in listed)
    nc = sum(c[1] for c in listed)
    ops = niter * dense * Hp * Wp + med7 * n7 + clean * nc
    # f32 frame and bool inmask in, f32 clean and bool crmask out
    bnd = bound(10.0 * H * W, f32_ops=ops)
    old_bnd = bound(10.0 * H * W, f32_ops=niter * first * Hp * Wp)
    print(f"K7 lacosmic_fused {H}x{W} (padded {Hp}x{Wp}), {niter} iterations "
          f"({nflag} pixels flagged; listed for the 7x7 median / the clean "
          f"by iteration: {listed}): bit-exact, kernel {ms:.3f} ms "
          f"(previous design: {PREVIOUS_MS['K7']:.3f}), plain "
          f"{plain:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}, "
          f"{ops / (niter * Hp * Wp):.2f} ops/px/iteration: {dense:g} "
          f"dense, {med7:.0f} a listed 7x7 median, {clean:.0f} a listed "
          f"clean); every stage everywhere: {first:.0f} ops/px/iteration, "
          f"bound {old_bnd[0]:.3f} ms [{card}]")
    return dict(entry("lacosmic_fused", "blackbox_tpu_torch/csrc/lacosmic.cu",
                      "blackbox_tpu/pallas/lacosmic.py:120", err, ms, plain,
                      *bnd),
                dense_bound_ms=old_bnd[0], listed=listed)


def check_k3(card, ctx, mesh, stdm):
    """K3 on a calibrated frame's two background meshes at 10560²,
    bit-exact against its plain version; timed for one mesh, as
    ``mini2back`` launches it, beside ``torch.linalg.multi_dot``."""
    from blackbox_tpu_torch.ops import upsample
    from blackbox_tpu_torch.ops.background import _catmull_rom_matrix
    H, W = ctx.geom.red_shape
    box = ctx.bkg_boxsize
    ny, nx = mesh.shape
    Wy = torch.tensor(_catmull_rom_matrix(H, ny, box), device="cuda")
    Wx = torch.tensor(_catmull_rom_matrix(W, nx, box), device="cuda")
    got = upsample.upsample_mesh((mesh, stdm), Wy, Wx, (H, W))
    ref = upsample._upsample_plain((mesh, stdm), Wy, Wx, (H, W))
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: upsample.upsample_mesh((mesh,), Wy, Wx, (H, W)))
    plain = cuda_ms(lambda: upsample._upsample_plain((mesh,), Wy, Wx,
                                                     (H, W)), reps=1)
    lib = cuda_ms(lambda: torch.linalg.multi_dot([Wy, mesh, Wx.T]))
    # weights and mesh read, the plane written; a multiply and an add
    # for each nonzero weight of a band: the (H, nx) first product, then
    # every output pixel
    width = [int((b[:, 1] - b[:, 0] + 1).clamp(min=0).sum())
             for b in (upsample.weight_bands(Wy), upsample.weight_bands(Wx))]
    bnd = bound(4.0 * (H * W + H * ny + W * nx + ny * nx),
                f32_ops=2.0 * (width[0] * nx + width[1] * H))
    print(f"K3 upsample_mesh {ny}x{nx} -> {H}x{W} (two meshes): bit-exact, "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms, library multi_dot "
          f"{lib:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    return entry("upsample_mesh", "blackbox_tpu_torch/csrc/upsample.cu",
                 "blackbox_tpu/pallas/upsample.py:35", err, ms, plain, *bnd,
                 library_ms=lib)


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
    for k in ("x", "y", "flux_ap", "fluxerr_ap", "fwhm", "flux_psf",
              "fluxerr_psf"):
        if not bool(torch.isfinite(out["cat"][k][valid]).all()):
            raise AssertionError(f"{label}: catalog {k} not finite")
    if ctx.geom.red_shape[0] > 1000 and int(out["stats"]["psf_nstars"]) < 20:
        raise AssertionError(f"{label}: the PSF fit used "
                             f"{int(out['stats']['psf_nstars'])} stars")


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
    cpu = make_reduce_fn(ctx, device="cpu")(chan, osv, osh, None, mflat,
                                            None, xtalk)
    gpu = make_reduce_fn(ctx)(chan, osv, osh, None, mflat, None, xtalk)
    torch.cuda.synchronize()
    if gpu["image"].device.type != "cuda":
        raise AssertionError("TINY: make_reduce_fn did not run on the card")
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


def counters():
    """The launch-counted wrappers, one per kernel, by JSON name."""
    from blackbox_tpu_torch.ops import detection, fft, filters, labeling
    from blackbox_tpu_torch.ops import lacosmic_fused, upsample, windows
    return {"label_propagate": labeling.label_propagate,
            "median_filter": filters.median_filter,
            "gather_slot_windows": windows.gather_slot_windows,
            "fft_cols_split": fft.fft_cols_split,
            "fused_detect": detection.fused_detect,
            "lacosmic_fused": lacosmic_fused.lacosmic_fused,
            "upsample_mesh": upsample.upsample_mesh}


def zero_counts():
    for c in counters().values():
        c.launches = 0


def read_counts(label, card, needed):
    """The counts of the path just run; every kernel in ``needed`` must
    have been launched."""
    counts = {name: c.launches for name, c in counters().items()}
    print(f"{label} launches {counts} [{card}]")
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on {label}")
    return counts


def check_frame(out, ctx, label, ms, card):
    """A full frame's outputs and the gates of the raw -> catalog path:
    nobjects 3000..5000 (4020 sources injected), cosmics and a trail
    found, a finite PSF."""
    check_outputs(out, ctx, label)
    st = out["stats"]
    nobj, ncr, nsat = (int(st["nobjects"]), int(st["ncosmics"]),
                       int(st["nsats"]))
    fwhm = float(st["psf_fwhm_pix"])
    print(f"{label}: {ms:.1f} ms, nobjects {nobj}, ncosmics {ncr}, nsats "
          f"{nsat}, seeing {float(st['s_seeing_pix']):.2f} px, PSF "
          f"{int(st['psf_nstars'])} stars, FWHM {fwhm:.2f} px, elongation "
          f"STD {float(st['s_elostd']):.2f} (QC red above 10) [{card}]")
    if not 3000 <= nobj <= 5000:
        raise AssertionError(f"{label}: nobjects {nobj} outside "
                             "3000..5000 (4020 sources injected)")
    if ncr <= 0 or nsat < 1:
        raise AssertionError(f"{label}: ncosmics {ncr}, nsats {nsat}")
    if not np.isfinite(fwhm):
        raise AssertionError(f"{label}: PSF FWHM {fwhm}")


def reduce_phase(ctx, card, mbias, mflat, xtalk):
    """Phase 3: three full MeerLICHT frames through make_reduce_fn."""
    from blackbox_tpu_torch.pipeline.reduce import make_reduce_fn
    from blackbox_tpu_torch.synth.device import make_science_device

    geom = ctx.geom
    fn = make_reduce_fn(ctx)
    torch.cuda.reset_peak_memory_stats()
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
        check_frame(out, ctx, f"frame {i} (seed {seed}"
                    f"{', warm-up' if i == 0 else ''})", ms, card)
        frame_ms.append(ms)
        del out, chan, osv, osh
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = frame_ms[1:]
    print(f"raw -> catalog: {sum(steady) / len(steady):.1f} ms/frame steady "
          f"(frames {', '.join(f'{m:.1f}' for m in steady)} ms after a "
          f"{frame_ms[0]:.1f} ms warm-up), peak memory {peak_gib:.2f} GiB "
          f"[{card}]")


def reference_products(ctx, front, chan, args):
    """The ref side, as bench.py builds it: the reduced frame scaled by
    FRATIO, its PSF stamp and its catalog."""
    from blackbox_tpu_torch.ops.stats import median
    f = front(chan, *args)
    cat = f["cat"]
    return dict(sub=f["sub"] * FRATIO, std=f["bkg_std"] * FRATIO,
                mask=f["mask"], psf=f["psf_centre"],
                sr=median(f["bkg_std"]) * FRATIO,
                cat={"x": cat["x"], "y": cat["y"],
                     "flux": cat["flux_psf"] * FRATIO,
                     "fluxerr": cat["fluxerr_psf"] * FRATIO,
                     "valid": cat["valid"]})


def inject_transients(geom, ctx, chan, mflat):
    """NTRANS Moffat transients (the frame's own PSF, 3e4 e-) added to
    the raw channel stacks through the flat and the gains."""
    from blackbox_tpu_torch.synth.device import moffat_kernel
    H, W = geom.red_shape
    rng = np.random.default_rng(7)
    edge = min(300, H // 6)
    xs = rng.uniform(edge, W - edge, NTRANS)
    ys = rng.uniform(edge, H - edge, NTRANS)
    delta = torch.zeros((H, W), device="cuda")
    delta[torch.as_tensor(ys.astype(np.int64)),
          torch.as_tensor(xs.astype(np.int64))] = 3.0e4
    trans_e = torch.fft.irfft2(torch.fft.rfft2(delta) * torch.fft.rfft2(
        moffat_kernel((H, W), 3.0, device="cuda")), s=(H, W))
    gain = torch.tensor(ctx.gains, device="cuda")
    chan_new = chan + (geom.disassemble(trans_e) * mflat
                       / gain[:, None, None])
    return chan_new, np.floor(xs), np.floor(ys)


def science_phase(ctx, card, mbias, mflat, xtalk):
    """Phase 4: raw -> transient catalog through make_science_programs.
    Returns the number of science frames run."""
    from blackbox_tpu_torch.ops.warp import grid_shift_ranges
    from blackbox_tpu_torch.pipeline.subtract import make_science_programs
    from blackbox_tpu_torch.synth.device import make_science_device

    geom = ctx.geom
    H, W = geom.red_shape
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[0])
    chan, osv, osh, _ = make_science_device(gen, geom, nstars=4000,
                                            ncosmics=800, trail=True,
                                            nsat=20)
    args = (osv, osh, mbias, mflat, None)
    front, _ = make_science_programs(ctx, xtalk)
    ref = reference_products(ctx, front, chan, args)
    nframes = 0

    # timed scene: bench.py's registration, ref_cat mapped the same way
    th = np.deg2rad(0.05)
    ct, st = np.cos(th), np.sin(th)
    cy, cx = 0.5 * H, 0.5 * W
    offx, offy, step = 3.2, -2.7, 32
    gy = np.arange(0, H + step, step, np.float64)
    gx = np.arange(0, W + step, step, np.float64)
    gyy, gxx = np.meshgrid(gy - cy, gx - cx, indexing="ij")
    sx = (cx + ct * gxx + st * gyy + offx).astype(np.float32)
    sy = (cy - st * gxx + ct * gyy + offy).astype(np.float32)
    rx = ref["cat"]["x"].double() - cx - offx
    ry = ref["cat"]["y"].double() - cy - offy
    cat_t = dict(ref["cat"], x=(cx + ct * rx - st * ry).float(),
                 y=(cy + st * rx + ct * ry).float())
    front, back = make_science_programs(
        ctx, xtalk, remap_ranges=grid_shift_ranges(sy, sx, step=step,
                                                   blocks=8),
        remap_step=step)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = front(chan, *args)
        b = back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                 f["cat"], f["stats"]["bkg_std"], ref["sub"], ref["std"],
                 ref["mask"], (sy, sx), ref["psf"], ref["sr"], cat_t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        nframes += 1
        ts = b["trans_stats"]
        print(f"science frame {i}{' (warm-up)' if i == 0 else ''}: "
              f"{times[-1]:.1f} ms raw -> transient catalog, z_fratio "
              f"{float(ts['z_fratio']):.4f}, z_nmatch {int(ts['z_nmatch'])},"
              f" t_ntrans {int(ts['t_ntrans'])} [{card}]")
        del f, b
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"raw -> transient catalog: {sum(times[1:]) / 2:.1f} ms/frame "
          f"steady (frames {times[1]:.1f}, {times[2]:.1f} ms after a "
          f"{times[0]:.1f} ms warm-up), peak memory {peak_gib:.2f} GiB "
          f"[{card}]")

    # gated scene: the ref rolled by an integer shift, transients in
    dy, dx = 3, -2
    roll = lambda a: torch.roll(a, (dy, dx), (0, 1))  # noqa: E731
    sy = np.broadcast_to(gy[:, None] + dy, (len(gy), len(gx))).astype(
        np.float32)
    sx = np.broadcast_to(gx[None, :] + dx, (len(gy), len(gx))).astype(
        np.float32)
    # the ref catalog is measured on the unrolled frame, which is the new
    # frame's grid: its positions need no mapping
    front, back = make_science_programs(
        ctx, xtalk, remap_ranges=grid_shift_ranges(sy, sx, step=step),
        remap_step=step)
    chan_new, tx, ty = inject_transients(geom, ctx, chan, mflat)
    del chan
    ref_g = (roll(ref["sub"]), roll(ref["std"]), roll(ref["mask"]), (sy, sx),
             ref["psf"], ref["sr"], ref["cat"])
    del ref

    def gated():
        f = front(chan_new, *args)
        b = back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                 f["cat"], f["stats"]["bkg_std"], *ref_g)
        return f["seg_nsources"], b

    n0, b0 = gated()
    nframes += 1
    check_gated(b0, tx, ty, card)
    from blackbox_tpu_torch.ops import detection
    k5 = detection.fused_detect.launches
    os.environ["BBTPU_PALLAS_DETECT"] = "1"
    try:
        n1, b1 = gated()
    finally:
        del os.environ["BBTPU_PALLAS_DETECT"]
    nframes += 1
    if detection.fused_detect.launches < k5 + 2:
        raise AssertionError("BBTPU_PALLAS_DETECT=1 did not route detection "
                             "and transients through fused_detect")
    if not torch.equal(n0, n1):
        raise AssertionError("K5 run: seg_nsources differs")
    for part in ("trans_cat", "trans_stats"):
        for k, v in b0[part].items():
            same = (torch.equal(v, b1[part][k]) if not v.is_floating_point()
                    else bool(((v == b1[part][k])
                               | (torch.isnan(v)
                                  & torch.isnan(b1[part][k]))).all()))
            if not same:
                raise AssertionError(f"K5 run: {part}[{k}] differs")
    print(f"gated scene with BBTPU_PALLAS_DETECT=1: seg_nsources "
          f"{int(n1)}, trans_cat and trans_stats bit-identical to the run "
          f"without it [{card}]")
    return nframes


def check_gated(b, tx, ty, card):
    """The gated scene's transients, flux ratio and maps."""
    ts, tc = b["trans_stats"], b["trans_cat"]
    for k in ("D", "Scorr", "Fpsf"):
        if not bool(torch.isfinite(b[k]).all()):
            raise AssertionError(f"gated scene: {k} is not finite")
    v = tc["valid"].cpu().numpy()
    x, y = tc["x"].cpu().numpy(), tc["y"].cpu().numpy()
    sign = tc["sign"].cpu().numpy()
    d = np.hypot(x[None, :] - tx[:, None], y[None, :] - ty[:, None])
    d = np.where(v[None, :], d, np.inf)
    found = int(((d < 2.0) & (sign[None, :] > 0)).any(1).sum())
    elsewhere = int((v & (d.min(0) > 3.0)).sum())
    fr = float(ts["z_fratio"])
    print(f"gated scene: {found} of {NTRANS} transients recovered within "
          f"2 px, {elsewhere} valid transients elsewhere, z_fratio {fr:.4f}"
          f", z_nmatch {int(ts['z_nmatch'])}, t_ntrans "
          f"{int(ts['t_ntrans'])} [{card}]")
    if found < 16:
        raise AssertionError(f"gated scene: {found} of {NTRANS} recovered")
    if abs(fr / FRATIO - 1.0) > 0.05:
        raise AssertionError(f"gated scene: z_fratio {fr}")
    if elsewhere > 20:
        raise AssertionError(f"gated scene: {elsewhere} spurious transients")


# a fixed, small (16, 3) fractional non-linearity: -0.2% to +0.5% across
# the ADU range, varying by channel
NONLIN = np.stack([1e-3 + 5e-4 * np.linspace(-1, 1, 16),
                   np.full(16, 2e-3), 1e-3 * np.linspace(-1, 1, 16) ** 2],
                  axis=1).astype(np.float32)


def calib_phase(ctx, card, xtalk):
    """Phase 5: a calibration night, masters, then science frames under
    LACosmicParams(use_pallas=True), with each frame's background planes
    made again by mini2back(..., use_pallas=True).  Returns the number
    of frames calibrated through K7 and what the first science frame
    leaves for phase 6: its raw frame, the masters, its cosmic count
    and mask, the inputs the reduction gave K7 and its two background
    meshes."""
    import dataclasses
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    from blackbox_tpu_torch.ops.background import background_mesh, mini2back
    from blackbox_tpu_torch.ops.flatstats import flat_statistics
    from blackbox_tpu_torch.pipeline.masters import master_bias, master_flat
    from blackbox_tpu_torch.pipeline.reduce import (calibrate_detector,
                                                    make_reduce_fn)
    from blackbox_tpu_torch.synth.device import make_science_device

    geom = ctx.geom
    H, W = geom.red_shape
    k7 = dataclasses.replace(ctx.lac_params, use_pallas=True)
    cal_ctx = dataclasses.replace(ctx, correct_nonlin=True, lac_params=k7)
    nk7 = 0

    def calibrate(seed, sky, mbias):
        """A raw bias/flat-like frame calibrated as the driver calibrates
        calibration frames: no crosstalk, non-linearity on, no flat."""
        nonlocal nk7
        gen = torch.Generator(device="cuda").manual_seed(seed)
        raw = make_science_device(gen, geom, nstars=0, sky_e=sky,
                                  ncosmics=0, trail=False, nsat=0)[:3]
        with torch.inference_mode():
            sci, _, _ = calibrate_detector(cal_ctx, *raw, mbias, None, None,
                                           None, nonlin_coeffs=NONLIN)
        nk7 += 1
        return geom.disassemble(sci)

    def finite(label, tensors):
        for k, v in tensors.items():
            if not bool(torch.isfinite(torch.as_tensor(v).double()).all()):
                raise AssertionError(f"{label}: {k} is not finite")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mbias, bstats = master_bias(torch.stack(
        [calibrate(400 + i, 0.0, None) for i in range(3)]))
    flats = torch.stack([calibrate(500 + i, 2e4, mbias) for i in range(3)])
    norm_sec = (slice(H // 2 - H // 8, H // 2 + H // 8),
                slice(W // 2 - W // 8, W // 2 + W // 8))
    mflat, fstats = master_flat(flats, geom, norm_sec)
    del flats
    flatst = flat_statistics(geom.assemble(mflat),
                             torch.zeros((H, W), dtype=torch.uint8,
                                         device="cuda"),
                             geom, norm_sec, max(min(H, W) // 8, 8))
    torch.cuda.synchronize()
    night_ms = (time.perf_counter() - t0) * 1e3
    finite("master bias", {"master": mbias, **bstats})
    finite("master flat", {"master": mflat, **fstats})
    finite("flat statistics", flatst)
    g = fstats["gaincf"]
    gmed = float(fstats["mflat_med"])
    print(f"calibration night: 3 bias + 3 flat frames calibrated with K7 "
          f"and non-linearity, masters and flat statistics in "
          f"{night_ms:.1f} ms; master bias mean "
          f"{float(bstats['mbias_mean']):.3f} e-, master flat median "
          f"{gmed:.4f}, GAINCF {float(g.min()):.4f}..{float(g.max()):.4f} "
          f"(mean {float(g.mean()):.7f}), flat RDIF-MAX "
          f"{float(flatst['rdif_max']):.4f} [{card}]")
    if g.shape != (16,) or not bool((g > 0).all()) \
            or abs(float(g.mean()) - 1.0) > 1e-5:
        raise AssertionError(f"GAINCF {g.tolist()}")
    if abs(gmed - 1.0) > 0.1:
        raise AssertionError(f"master flat median {gmed}")

    fn_k7 = make_reduce_fn(dataclasses.replace(ctx, lac_params=k7))
    run = K7._run_cuda
    first = {"masters": (mbias, mflat)}

    def record(*args):
        """K7's iteration loop on the card, keeping a copy of the first
        call's inputs (data, inmask, read noise, sigclip, sigfrac,
        objlim, niter)."""
        first.setdefault("k7", tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args[:7]))
        return run(*args)

    for i, seed in enumerate(SEEDS[:2]):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        raw = make_science_device(gen, geom, nstars=4000, ncosmics=800,
                                  trail=True, nsat=20)[:3]
        K7._run_cuda = record if i == 0 else run
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn_k7(*raw, mbias, mflat, None, xtalk)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            K7._run_cuda = run
        nk7 += 1
        check_frame(out, ctx, f"science frame {i} (seed {seed}) with K7", ms,
                    card)
        mesh, stdm = background_mesh(out["image"], out["mask"] != 0,
                                     ctx.bkg_boxsize, nsigma=ctx.bkg_nsigma,
                                     filtersize=ctx.bkg_filtersize)
        for m, k in ((mesh, "bkg"), (stdm, "bkg_std")):
            d = float((mini2back(m, (H, W), ctx.bkg_boxsize, use_pallas=True)
                       - out[k]).abs().max())
            print(f"science frame {i}: mini2back(use_pallas=True) against "
                  f"the reduction's {k}: max |diff| {d:.3g} e- at levels up "
                  f"to {float(out[k].abs().max()):.1f} e- [{card}]")
            if d > 1e-3:
                raise AssertionError(f"K3 {k} differs by {d} e-")
        if i == 0:
            first.update(raw=raw, mask=out["mask"], meshes=(mesh, stdm),
                         ncosmics=int(out["stats"]["ncosmics"]))
        del out, raw
    if "k7" not in first:
        raise AssertionError("the use_pallas=True reduction never called K7")
    return nk7, first


def compare_default(ctx, card, xtalk, first):
    """Phase 6: the first K7 science frame reduced again with the default
    L.A.Cosmic and the same masters; the two cosmic masks, more than 4
    px inside the frame, must agree to a Jaccard index of 0.9."""
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.pipeline.reduce import make_reduce_fn

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = make_reduce_fn(ctx)(*first.pop("raw"), *first["masters"], None,
                                xtalk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_frame(dense, ctx, f"science frame 0 (seed {SEEDS[0]}) with the "
                "default L.A.Cosmic", ms, card)
    a, b = ((m[4:-4, 4:-4] & maskbits.COSMIC) != 0
            for m in (first.pop("mask"), dense["mask"]))
    jac = int((a & b).sum()) / max(int((a | b).sum()), 1)
    print(f"K7 against the default L.A.Cosmic on the same calibrated frame: "
          f"cosmic-mask Jaccard {jac:.4f} ({int(a.sum())} and {int(b.sum())}"
          f" px), NCOSMICS {first['ncosmics']} and "
          f"{int(dense['stats']['ncosmics'])} [{card}]")
    if jac < 0.9:
        raise AssertionError(f"cosmic-mask Jaccard {jac}")


# ---------------------------------------------------------------- phase 7

NIGHT_DATE = "20260301"
NIGHT_SHIFT = (3, -2)   # (dx, dy) px of the second visit's pointing
NIGHT_SCALE = 0.8       # the second visit's transparency: Z-FRATIO 1.25


def raw_mosaic(geom, chan, osv, osh):
    """The raw uint16 mosaic whose ``geom.split_raw`` gives back the
    stacks (``chan``, ``osv``, ``osh``, ADU, rounded): the inverse of
    the split, with the cut overscan columns filled at the bias level
    (the split drops them), on the stacks' device."""
    C, (ny, nx, dy, dx) = geom.n_chan, (geom.ny, geom.nx, geom.dy, geom.dx)
    ych, xch, h = geom.ysize_chan, geom.xsize_chan, geom.os_hori_height
    full = osv[:, :, :1].expand(C, dy, dx).clone()
    full[:, :, xch + geom.ncut_vert:dx - 1] = osv
    full[:nx, dy - h:dy, :] = osh[:nx]
    full[nx:, 0:h, :] = osh[nx:]
    full[:nx, :ych, :xch] = chan[:nx]
    full[nx:, geom.ysize_os:, :xch] = chan[nx:]
    raw = full.reshape(ny, nx, dy, dx).permute(0, 2, 1, 3).reshape(
        geom.raw_shape)
    return torch.clamp(torch.round(raw), 0, 65535).to(torch.int32)


def write_raw(path, geom, stacks, imgtype, mjd, exptime, ra, dec):
    """One raw frame as the telescope writes it (uint16, survey
    header), from its channel stacks on the card."""
    from blackbox_tpu_torch.io.fits import write_image
    from blackbox_tpu_torch.synth.observation import raw_header
    raw = raw_mosaic(geom, *stacks).cpu().numpy().astype(np.uint16)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_image(path, raw, raw_header("ML1", imgtype, mjd, exptime, "q", 42,
                                      ra, dec))


def tiny_night_phase(card):
    """Phase 7, first part: the TINY night of tests/test_torch_driver.py
    through the port's Pipeline on the card and on the CPU (plain
    versions), each in its own copy of the raw tree, held together by
    tests/night_parity.py: statuses, product names, keywords and flags,
    masks bit for bit, images, catalogs and transients at the tier-1
    parity tolerances.  Quicklooks are off: this machine has no PIL
    (tier-1 covers them on the CPU)."""
    import shutil
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import night_parity as NP
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline

    with tempfile.TemporaryDirectory() as base:
        files, stars = NP.tiny_night(os.path.join(base, "raw"))
        s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                              create_ref=True, make_quicklooks=False)
        runs = {}
        for device in ("cuda", "cpu"):
            root = os.path.join(base, device)
            shutil.copytree(os.path.join(base, "raw"), root)
            pipe = Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                            ref_catalog=NP.ref_catalog(stars,
                                                       TINY.red_shape),
                            device=device)
            runs[device] = ([pipe.process_file(
                os.path.join(root, os.path.relpath(f, os.path.join(
                    base, "raw")))) for f in files], root)
        gpu, cpu = runs["cuda"], runs["cpu"]
        statuses = [r.status for r in gpu[0]]
        errors = [r.error for r in gpu[0] if r.error]
        if statuses != ["reduced"] * len(files):
            raise AssertionError(f"TINY night on the card: {statuses} "
                                 f"{errors}")
        x, y = NP.check_night(gpu, cpu, NP.overscan_level(cpu))
        h = gpu[0][-1].header
    d = np.hypot(x - NP.TRANS[0], y - NP.TRANS[1])
    if d.min() >= 2.0:
        raise AssertionError(f"TINY night: no transient within 2 px of "
                             f"{NP.TRANS[:2]}")
    print(f"TINY night ({len(files)} frames) on the card vs the CPU: "
          f"statuses, products, keywords and flags equal, masks bit for "
          f"bit, images, catalogs and transients within the parity "
          f"tolerances; second visit T-NTRANS {h['T-NTRANS']}, Z-FRATIO "
          f"{h['Z-FRATIO']}, the transient found {d.min():.2f} px from "
          f"its place [{card}]")


def night_phase(ctx, card, root):
    """Phase 7, second part: a full MeerLICHT night, file to file, through
    the port's Pipeline on the card.  3 bias, 3 flat and 2 object frames
    of field 42 (10600 x 10816 uint16 raw, made on the card by
    make_science_device and written with the port's io/fits), settings
    ReductionSettings(geometry=MEERLICHT, create_ref=True,
    subtract_mbias=True, make_quicklooks=False) (this machine has no
    PIL; tier-1 covers the quicklooks on the CPU).  The first visit
    (4000 stars + 20 saturated, 800 cosmics) is adopted as the field
    reference; the second points NIGHT_SHIFT pixels off (the two-pass
    remap), at NIGHT_SCALE of the first's transparency, with its own
    noise and cosmics and NTRANS PSF-shaped transients.  Neither visit
    carries a satellite trail: the synthetic trail leaves 3-pixel
    fragments beside its mask whose second moments are degenerate
    (elongation ~1e3, ``ops/detection.moments_shape`` floors B² at
    1e-6 as the JAX package does), which sends S-ELOSTD to ~32 (phase
    3 prints it) and the frame to QC red, so no reference would be
    adopted (ROADMAP Queue 3).  The night's tree is under ``root``.
    Returns the launch counts of the night and what phase 8 continues
    from: the pipeline, the frames' results, the first visit's stars and
    WCS, and the raw-frame writer."""
    import tempfile
    from blackbox_tpu_torch.astro.time import iso2mjd, mjd2iso
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.io import rice
    from blackbox_tpu_torch.io.fits import read_fits
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline import driver
    from blackbox_tpu_torch.synth.device import make_science_device

    if rice.coder() != "compiled":
        raise AssertionError("the compiled Rice coder did not load")
    print(f"Rice coder: {rice.coder()} [{card}]")
    geom = ctx.geom
    H, W = geom.red_shape
    s = ReductionSettings(geometry=geom, create_ref=True,
                          subtract_mbias=True, make_quicklooks=False)
    pixscale, ra0, dec0 = s.pixscale, 150.0, -30.0
    t_phase = time.time()
    tree = DataTree(root, "ML1")
    rawdir = tree.raw_dir(NIGHT_DATE)
    mjd0 = iso2mjd(f"{NIGHT_DATE[:4]}-{NIGHT_DATE[4:6]}-"
                   f"{NIGHT_DATE[6:]}T23:00:00.000")
    files = []

    def write(stacks, imgtype, k, exptime, ra, dec):
        mjd = mjd0 + k * 120.0 / 86400.0
        ts = mjd2iso(mjd).replace("-", "").replace(":", "")
        path = os.path.join(rawdir, f"ML1_{ts[:8]}_{ts[9:15]}.fits")
        write_raw(path, geom, stacks, imgtype, mjd, exptime, ra, dec)
        files.append(path)
        return path

    t0 = time.time()
    for k in range(6):
        gen = torch.Generator(device="cuda").manual_seed(700 + k)
        flat = k >= 3
        stacks = make_science_device(gen, geom, nstars=0,
                                     sky_e=2e4 if flat else 0.0,
                                     ncosmics=0, trail=False,
                                     nsat=0)[:3]
        write(stacks, "flat" if flat else "bias", k,
              3.0 if flat else 0.0, ra0 + (k - 3) * 15.0 / 3600, dec0)
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[0])
    *stacks, truth = make_science_device(gen, geom, nstars=4000,
                                         ncosmics=800, trail=False,
                                         nsat=20)
    write(stacks, "object", 6, 60.0, ra0, dec0)
    # the second visit: the same stars moved and dimmed, 20 new
    # point sources; its pointing follows the move
    dx, dy = NIGHT_SHIFT
    rng = np.random.default_rng(7)
    edge = min(300, H // 6)
    tx = np.floor(rng.uniform(edge, W - edge, NTRANS))
    ty = np.floor(rng.uniform(edge, H - edge, NTRANS))
    stars2 = (torch.cat([truth["x"] + dx, torch.as_tensor(
                  tx, dtype=torch.float32, device="cuda")]),
              torch.cat([truth["y"] + dy, torch.as_tensor(
                  ty, dtype=torch.float32, device="cuda")]),
              torch.cat([truth["flux"] * NIGHT_SCALE, torch.full(
                  (NTRANS,), 3.0e4, device="cuda")]))
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[1])
    stacks = make_science_device(gen, geom, ncosmics=800, trail=False,
                                 stars=stars2)[:3]
    wcs1 = TanWCS.simple(ra0, dec0, pixscale, (H, W))
    ra2, dec2 = wcs1.pix2sky(W / 2 - dx, H / 2 - dy)
    write(stacks, "object", 7, 60.0, float(ra2), float(dec2))
    del stacks, stars2
    torch.cuda.synchronize()
    write_s = time.time() - t0
    nbytes = sum(os.path.getsize(f) for f in files)

    # calibration stars: the first visit's unsaturated sources
    xs, ys, fl = (truth[k].cpu().numpy().astype(np.float64)
                  for k in ("x", "y", "flux"))
    keep = fl < 1e6
    ra, dec = wcs1.pix2sky(np.floor(xs[keep]), np.floor(ys[keep]))
    mag = 25.0 - 2.5 * np.log10(fl[keep] / 60.0)

    def query(ra_c, dec_c, radius):
        return {"ra": ra, "dec": dec, "mag": mag}

    pipe = driver.Pipeline(tree, "ML1", s,
                           dataclasses.replace(ctx, subtract_mbias=True),
                           ref_catalog=query)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = []
    for f in files:
        res.append(pipe.process_file(f))
        r = res[-1]
        t = r.timing
        if r.header is not None and "S-P" in r.header:
            h = r.header
            print(f"  {os.path.basename(f)}: " + ", ".join(
                f"{k} {h.get(k)}" for k in (
                    "QC-FLAG", "MBIAS-P", "MFLAT-P", "S-P", "NOBJECTS",
                    "A-P", "A-RMS", "PC-P", "PC-ZP", "REF-NEW",
                    "TRANS-P", "T-NTRANS", "Z-FRATIO", "TQC-FLAG"))
                  + ", red keys " + str([h[k] for k in h.keys()
                                         if k.startswith("QCRED")]))
        ms = {k: v * 1e3 for k, v in t.items()}
        dev_ms = (ms.get(driver.SPAN_CALIB, 0.0)
                  + ms.get(driver.SPAN_SUBTRACT, 0.0))
        host_ms = ms["wall"] - dev_ms
        parts = (driver.SPAN_MASTERS, driver.SPAN_READ, driver.SPAN_RICE,
                 driver.SPAN_REF, driver.SPAN_COMPONENTS)
        other = host_ms - sum(ms.get(k, 0.0) for k in parts)
        kind = str(r.header["IMAGETYP"]).strip() if r.header else "?"
        print(f"file -> file {os.path.basename(f)} ({kind}): "
              f"{r.status}, wall {ms['wall']:.1f} ms, device "
              f"{dev_ms:.1f} ms (calibrate+extract "
              f"{ms.get(driver.SPAN_CALIB, 0.0):.1f}, run_subtraction "
              f"{ms.get(driver.SPAN_SUBTRACT, 0.0):.1f}), host "
              f"{host_ms:.1f} ms (" + ", ".join(
                  f"{k} {ms.get(k, 0.0):.1f}" for k in parts)
              + f", other {other:.1f}) [{card}]")
    torch.cuda.synchronize()
    counts = read_counts("file -> file night", card,
                         ("label_propagate", "median_filter",
                          "gather_slot_windows", "fft_cols_split"))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check_night_flags(res, card)
    trans = [p for p in res[-1].products
             if p.endswith("_red_trans.fits")][0]
    cols = next(d for d, _ in read_fits(trans) if isinstance(d, dict))
    found = check_night_transients(cols, tx, ty, card)
    # one K1 launch a catalog (two object frames) and one for the
    # subtraction's transients; six K6 launches for the one subtraction
    if counts["label_propagate"] != 2 + 1:
        raise AssertionError(f"label_propagate: {counts['label_propagate']}"
                             " launches for 2 catalogs and 1 subtraction")
    if counts["fft_cols_split"] != 6:
        raise AssertionError(f"fft_cols_split: {counts['fft_cols_split']} "
                             "launches for 1 subtraction")
    print(f"file -> file night: {len(files)} frames ({nbytes / 2 ** 30:.2f}"
          f" GiB of raw files, written in {write_s:.1f} s), {found} of "
          f"{NTRANS} transients recovered, peak memory {peak_gib:.2f} GiB, "
          f"phase {time.time() - t_phase:.1f} s [{card}]")
    return counts, dict(root=root, tree=tree, pipe=pipe, settings=s,
                        res=res, truth=truth, wcs1=wcs1, write=write,
                        trans=(tx, ty))


def check_night_flags(res, card):
    """The full night's statuses and flags."""
    bad = [(r.status, r.error) for r in res if r.status != "reduced"]
    if bad:
        raise AssertionError(f"night frames not reduced: {bad}")
    for i, r in enumerate(res[6:]):
        h = r.header
        for k in ("MBIAS-P", "MFLAT-P", "S-P", "A-P", "PC-P", "PSF-P"):
            if h.get(k) is not True:
                raise AssertionError(f"object frame {i}: {k} = {h.get(k)}")
        nobj = int(h["NOBJECTS"])
        if not 3000 <= nobj <= 5000:
            raise AssertionError(f"object frame {i}: NOBJECTS {nobj} outside"
                                 " 3000..5000 (4020 sources injected)")
    h1, h2 = res[6].header, res[7].header
    if h1.get("REF-NEW") is not True:
        raise AssertionError("the first visit was not adopted as reference")
    if h2.get("TRANS-P") is not True:
        raise AssertionError(f"the second visit: TRANS-P {h2.get('TRANS-P')}"
                             f", TQC-FLAG {h2.get('TQC-FLAG')}")
    fr = float(h2["Z-FRATIO"])
    if abs(fr * NIGHT_SCALE - 1.0) > 0.05:
        raise AssertionError(f"Z-FRATIO {fr}, true {1 / NIGHT_SCALE}")
    print(f"file -> file night flags: MBIAS-P, MFLAT-P, S-P, A-P, PC-P true "
          f"on both visits (NOBJECTS {h1['NOBJECTS']}, {h2['NOBJECTS']}; "
          f"A-RMS {h1['A-RMS']}, {h2['A-RMS']} arcsec; PC-ZP {h1['PC-ZP']}, "
          f"{h2['PC-ZP']}), REF-NEW on the first, TRANS-P on the second: "
          f"T-NTRANS {h2['T-NTRANS']}, Z-FRATIO {fr} (true "
          f"{1 / NIGHT_SCALE}), Z-DXRMS {h2['Z-DXRMS']}, TQC-FLAG "
          f"{h2.get('TQC-FLAG')} [{card}]")


def check_night_transients(cols, tx, ty, card):
    """At least 16 of the NTRANS transients in the published catalog,
    within 2 px with positive flux."""
    x = np.asarray(cols["X_PEAK"], np.float64) - 1
    y = np.asarray(cols["Y_PEAK"], np.float64) - 1
    pos = np.asarray(cols["E_FLUX_ZOGY"]) > 0
    d = np.hypot(x[None, :] - tx[:, None], y[None, :] - ty[:, None])
    found = int(((d < 2.0) & pos[None, :]).any(1).sum())
    print(f"file -> file night: {found} of {NTRANS} transients in the "
          f"published _red_trans.fits within 2 px with positive flux, "
          f"{len(x)} rows [{card}]")
    if found < 16:
        raise AssertionError(f"night: {found} of {NTRANS} transients")
    return found


# ---------------------------------------------------------------- phase 8

COADD_DITHER = (-4, 3)  # (dx, dy) px of the third visit's pointing
COADD_ROT = 0.05        # deg, the third visit's rotation
FOURTH_SHIFT = (2, -3)  # (dx, dy) px of the fourth visit's pointing
EXPTIME = 60.0          # s, every visit's exposure


def visit_stars(truth, dx, dy, rot_deg, scale, geom):
    """The first visit's stars as a later visit sees them: rotated by
    ``rot_deg`` about the frame centre, moved (dx, dy) px, at ``scale``
    of its transparency; and that visit's pointing (the sky at its
    centre pixel, through the first visit's WCS ``wcs1``) as a function
    of wcs1."""
    H, W = geom.red_shape
    cx, cy = W / 2, H / 2
    c, s = math.cos(math.radians(rot_deg)), math.sin(math.radians(rot_deg))
    x, y = truth["x"] - cx, truth["y"] - cy
    stars = (cx + c * x - s * y + dx, cy + s * x + c * y + dy,
             truth["flux"] * scale)

    def pointing(wcs1):
        # the centre shows the first visit's pixel c - R^-1 d
        ra, dec = wcs1.pix2sky(cx - (c * dx + s * dy), cy - (-s * dx + c * dy))
        return float(ra), float(dec)
    return stars, pointing


def check_visit(r, label, card, keys=("S-P", "A-P", "PC-P")):
    if r.status != "reduced":
        raise AssertionError(f"{label}: {r.status} {r.error}")
    h = r.header
    for k in keys:
        if h.get(k) is not True:
            raise AssertionError(f"{label}: {k} = {h.get(k)}")
    if r.qc_flag == "red":
        raise AssertionError(f"{label}: QC red")
    ms = r.timing["wall"] * 1e3
    print(f"{label}: {r.status}, QC {r.qc_flag}, " + ", ".join(
        f"{k} {h.get(k)}" for k in ("NOBJECTS", "A-RMS", "PC-ZP", "LIMMAG",
                                    "S-SEEING"))
          + f", wall {ms:.1f} ms [{card}]")


def compare_coadds(got, want, label, card):
    """Two co-adds of the same inputs (numpy dicts).  Their remaps may
    differ by float32 rounding: the resident co-add casts source
    coordinates of up to 1e4 px to float32 (~1e-3 px, as the JAX package
    does), the blocked one slab-local ones.  So a clip decision at its
    threshold may flip, and a nearest-sampled mask or std pixel at a
    half-pixel tie, or an input at the frame's edge, may take its
    neighbour.  Held: the pixels where the clip decisions, the weight
    sums (within 1e-5), the masks or the images differ (the images
    beyond 0.05 e- plus 4e-3 px times the local gradient, twice that
    coordinate rounding in x and y) are under 1e-3 of the frame, as
    tests/test_coadd.py allows for clip flips.  The worst pixels are
    printed."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    gi, wi = t(got["image"]), t(want["image"])
    flip = (t(got["nclipped"]).to(torch.int32)
            != t(want["nclipped"]).to(torch.int32))
    weight = ~flip & ((t(got["wsum"]) - t(want["wsum"])).abs() > 1e-5)
    maskd = t(got["mask"]) != t(want["mask"])
    d = (gi - wi).abs()
    g = torch.zeros_like(wi)
    for diff, a, b in (((wi[:, 1:] - wi[:, :-1]).abs(), (slice(None),
                        slice(1, None)), (slice(None), slice(None, -1))),
                       ((wi[1:] - wi[:-1]).abs(), (slice(1, None),),
                        (slice(None, -1),))):
        g[a] = torch.maximum(g[a], diff)
        g[b] = torch.maximum(g[b], diff)
    tol = 0.05 + 4e-3 * g
    agree = ~(flip | weight | maskd)
    over = agree & (d > tol)
    bad = ~agree | over
    n = d.numel()
    dflat = d[agree & (g < 10.0)]
    print(f"{label}: {int(flip.sum())} clip flips, {int(weight.sum())} other "
          f"weight changes, {int(maskd.sum())} mask pixels, {int(over.sum())} "
          f"image pixels over 0.05 e- + 4e-3 px x gradient: "
          f"{int(bad.sum())} pixels ({float(bad.sum()) / n:.2e} of the "
          f"frame); elsewhere max |d image| {float(d[~bad].max()):.4g} e- "
          f"({float(dflat.max()) if dflat.numel() else 0.0:.4g} where the "
          f"gradient is under 10 e-/px); bit-identical "
          f"{bool(torch.equal(gi, wi))} [{card}]")
    worst = torch.topk(torch.where(bad, d / tol, 0.0).reshape(-1),
                       min(3, max(int(bad.sum()), 1))).indices
    for k in worst.tolist():
        y, x = divmod(k, gi.shape[1])
        if not bool(bad[y, x]):
            continue
        print(f"  ({y}, {x}): image {float(gi[y, x]):.4f} / "
              f"{float(wi[y, x]):.4f}, wsum {float(got['wsum'][y, x]):.6g} "
              f"/ {float(want['wsum'][y, x]):.6g}, nclipped "
              f"{int(got['nclipped'][y, x])} / {int(want['nclipped'][y, x])},"
              f" mask {int(got['mask'][y, x])} / {int(want['mask'][y, x])},"
              f" gradient {float(g[y, x]):.4g} [{card}]")
    if float(bad.sum()) / n >= 1e-3:
        raise AssertionError(f"{label}: co-adds differ")


def coadd_phase(card, night):
    """Phase 8, in phase 7's tree and night: a third visit, the command
    line's --buildref over the three visits (not_deeper against the
    single frame), the reference co-add published (the blocked
    combiner, K1 and K4 in its catalog and PSF), the resident combiner
    and the full-res std source held against it, and a fourth visit
    subtracted against the co-add.  Returns the launch counts of the
    phase."""
    import contextlib
    import io
    import logging
    from blackbox_tpu_torch.__main__ import main as cli_main
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.io.fits import read_fits
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.ops.coadd import saturation_protect
    from blackbox_tpu_torch.ops.stats import median
    from blackbox_tpu_torch.pipeline import buildref as B
    from blackbox_tpu_torch.synth.device import make_science_device

    t_phase = time.time()
    pipe, tree, truth = night["pipe"], night["tree"], night["truth"]
    geom, ctx = pipe.geom, pipe.ctx
    H, W = geom.red_shape
    res7 = night["res"]
    zero_counts()

    # 1. a third visit: new noise and cosmics, dithered and rotated
    stars3, pointing3 = visit_stars(truth, *COADD_DITHER, COADD_ROT, 1.0,
                                    geom)
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[2])
    stacks = make_science_device(gen, geom, ncosmics=800, trail=False,
                                 stars=stars3)[:3]
    p3 = night["write"](stacks, "object", 8, EXPTIME,
                        *pointing3(night["wcs1"]))
    del stacks, stars3
    r3 = pipe.process_file(p3, trans_extract=False)
    check_visit(r3, "third visit (trans_extract=False)", card)

    # 2a. the command line over the three visits, against the adopted
    # single-frame reference, with the default gate: not_deeper, a fault
    # of the reference that the port matches (build_reference states
    # the co-add's LIMMAG for 1 s, a frame's counts its EXPTIME)
    old = float(res7[6].header["LIMMAG"])
    fault = 2.5 * math.log10(EXPTIME)
    seen = []
    build0 = B.build_reference

    def build(*a, **kw):
        seen.append(build0(*a, **kw))
        return seen[-1]

    B.build_reference = build
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--buildref", "42", "--data_root", night["root"],
                           "--filters", "q"])
    finally:
        B.build_reference = build0
    t_cli = time.time() - t0
    logging.getLogger().setLevel(logging.WARNING)
    said = buf.getvalue().strip()
    print(f"python -m blackbox_tpu_torch --buildref 42: rc {rc}, {said!r}, "
          f"{t_cli:.1f} s [{card}]")
    if rc != 0 or "not_deeper" not in said:
        raise AssertionError(f"--buildref: rc {rc}, {said!r}")
    limmag = seen[0][1]["limmag"]
    if limmag + fault < old + 0.1:
        raise AssertionError(f"co-add LIMMAG {limmag} + {fault:.3f} not 0.1 "
                             f"mag above the single frame's {old}")
    print(f"co-add against the adopted single-frame reference: not_deeper "
          f"(LIMMAG {limmag:.4f} for 1 s against the frame's {old:.4f} for "
          f"{EXPTIME:.0f} s; {limmag + fault:.4f} for {EXPTIME:.0f} s, "
          f"{limmag + fault - old:.3f} mag deeper) [{card}]")

    bs = B.BuildRefSettings(nimages_min=3, limmag_target=30.0,
                            seeing_max=10.0)
    # 2b. the gate lowered by the fault's 2.5 log10(EXPTIME): published,
    # the single frame archived; the loads and the blocked combiner
    # timed (instrument=True), their outputs kept
    kept = {"inputs": [], "load_s": []}
    load0, blocked0 = B.load_ref_input, B.coadd_field_blocked

    def load(path, *a, **kw):
        t = time.perf_counter()
        inp = load0(path, *a, **kw)
        torch.cuda.synchronize()
        kept["load_s"].append(time.perf_counter() - t)
        kept["inputs"].append(inp)
        return inp

    def blocked(inputs, out_wcs, shape, s, **kw):
        t = time.perf_counter()
        out = blocked0(inputs, out_wcs, shape, s, instrument=True, **kw)
        kept.update(blocked=out, wcs=out_wcs, shape=shape, settings=s,
                    blocked_s=time.perf_counter() - t)
        return out

    before = {k: c.launches for k, c in counters().items()}
    B.load_ref_input, B.coadd_field_blocked = load, blocked
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        status, info = B.build_reference(tree, "ML1", 42, "q", bs,
                                         extract_ctx=ctx,
                                         dlimmag_min=0.1 - fault)
    finally:
        B.load_ref_input, B.coadd_field_blocked = load0, blocked0
    t_build = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {k: c.launches - before[k] for k, c in counters().items()}
    if status != "published":
        raise AssertionError(f"co-add: {status} {info}")
    _, h = read_rice(info["path"])
    if int(h["NIMAGES"]) != 3:
        raise AssertionError(f"co-add NIMAGES {h['NIMAGES']}")
    rdir = tree.ref_dir(42)
    arch = os.listdir(os.path.join(rdir, "ref-old"))
    if not any(f.endswith("_red.fits.fz") and "coadd" not in f
               for f in arch):
        raise AssertionError(f"the single frame is not under ref-old/: "
                             f"{arch}")
    for k in ("label_propagate", "gather_slot_windows"):
        if moved[k] <= 0:
            raise AssertionError(f"{k} did not move in build_reference")
    tim = kept["timings"] = kept["blocked"]["timings"]
    print(f"co-add published: NIMAGES {h['NIMAGES']}, LIMMAG {h['LIMMAG']}, "
          f"NOBJECTS {h['NOBJECTS']}, S-SEEING {h['S-SEEING']}, R-ASWARP "
          f"{h['R-ASWARP']}, R-NSIGMA {h['R-NSIGMA']}, QC {info['qc']}; the "
          f"single frame under ref-old/; launches in build_reference "
          f"{ {k: v for k, v in moved.items() if v} } [{card}]")
    print(f"co-add timing: build_reference {t_build:.1f} s; load_ref_input "
          + ", ".join(f"{t:.2f}" for t in kept["load_s"])
          + f" s; coadd_field_blocked {kept['blocked_s']:.2f} s (prep "
          f"{tim['prep_s']:.2f}, upload {tim['upload_s']:.2f}, compute "
          f"{tim['compute_s']:.2f}, drain {tim['drain_s']:.2f} s, "
          f"{tim['nblocks']} blocks, instrument=True); extraction and "
          f"products {t_build - sum(kept['load_s']) - kept['blocked_s']:.1f}"
          f" s; peak memory {peak:.2f} GiB [{card}]")

    out, inputs = kept["blocked"], kept["inputs"]
    med_co = float(median(torch.as_tensor(out["bkg_std"], device="cuda")))
    med_in = [float(median(inp.bkg_std)) for inp in inputs]
    if not med_co < min(med_in):
        raise AssertionError(f"co-add bkg_std {med_co} not below the "
                             f"inputs' {med_in}")
    # visit 2's transients: clipped at their cores, outside the
    # saturation protection
    tx, ty = night["trans"]
    w2 = TanWCS.from_header(res7[7].header)
    cx, cy = kept["wcs"].sky2pix(*w2.pix2sky(tx, ty))
    ix, iy = np.round(cx).astype(int), np.round(cy).astype(int)
    radius = int(np.ceil(bs.clip.protect_radius_fwhm
                         * max(inp.fwhm_pix for inp in inputs)))
    prot = saturation_protect(torch.as_tensor(out["mask"], device="cuda")[
        None], radius + 2).cpu().numpy()
    outside = ~prot[iy, ix]
    ncore = out["nclipped"][iy, ix]
    if not (ncore[outside] >= 1).all():
        raise AssertionError(f"transient cores not clipped: nclipped "
                             f"{ncore.tolist()}, outside protection "
                             f"{outside.tolist()}")
    cat = next(d for d, _ in read_fits(info["path"].replace(
        "_red.fits.fz", "_red_cat.fits")) if isinstance(d, dict))
    px = np.asarray(cat["X_POS"], np.float64) - 1
    py = np.asarray(cat["Y_POS"], np.float64) - 1
    d = np.hypot(px[None, :] - cx[:, None], py[None, :] - cy[:, None])
    left = int((d < 2.0).any(1).sum())
    print(f"co-add: median bkg_std {med_co:.4f} e- against the inputs' "
          + ", ".join(f"{m:.4f}" for m in med_in)
          + f"; visit 2's {NTRANS} transients clipped at their cores "
          f"({int(outside.sum())} outside the saturation protection, "
          f"nclipped there {sorted(set(ncore[outside].tolist()))}); the "
          f"co-add's catalog still detects {left} of them within 2 px "
          f"[{card}]")

    # 3. the resident combiner on the same inputs against the blocked
    # one, then the full-res std source against the mini-mesh one
    torch.cuda.synchronize()
    t0 = time.time()
    res = B.coadd_field(inputs, kept["wcs"], kept["shape"], kept["settings"])
    res = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in res.items()}
    t_res = time.time() - t0
    if res["zp"] != out["zp"]:
        raise AssertionError(f"resident zp {res['zp']}, blocked {out['zp']}")
    compare_coadds(res, out, f"resident coadd_field ({t_res:.1f} s) "
                   "against the blocked co-add", card)
    del res
    torch.cuda.empty_cache()
    full_in = [dataclasses.replace(inp, bkg_std_mini=None) for inp in inputs]
    t0 = time.time()
    full = B.coadd_field_blocked(full_in, kept["wcs"], kept["shape"],
                                 kept["settings"], instrument=True)
    t_full = time.time() - t0
    tf = full["timings"]
    compare_coadds(full, out, f"blocked co-add with the full-res std planes "
                   f"({t_full:.1f} s: prep {tf['prep_s']:.2f}, upload "
                   f"{tf['upload_s']:.2f}, compute {tf['compute_s']:.2f}, "
                   f"drain {tf['drain_s']:.2f}) against the mini-mesh std "
                   f"source", card)
    del full, full_in, out, kept, inputs
    torch.cuda.empty_cache()

    # 4. a fourth visit with NTRANS new transients, subtracted against
    # the co-add
    dx, dy = FOURTH_SHIFT
    rng = np.random.default_rng(8)
    edge = min(300, H // 6)
    tx4 = np.floor(rng.uniform(edge, W - edge, NTRANS))
    ty4 = np.floor(rng.uniform(edge, H - edge, NTRANS))
    (x4, y4, f4), pointing4 = visit_stars(truth, dx, dy, 0.0, NIGHT_SCALE,
                                          geom)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda")
    stars4 = (torch.cat([x4, as_t(tx4)]), torch.cat([y4, as_t(ty4)]),
              torch.cat([f4, torch.full((NTRANS,), 3.0e4, device="cuda")]))
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[2] + 1)
    stacks = make_science_device(gen, geom, ncosmics=800, trail=False,
                                 stars=stars4)[:3]
    p4 = night["write"](stacks, "object", 9, EXPTIME,
                        *pointing4(night["wcs1"]))
    del stacks, stars4
    ref = pipe._find_ref(42, "q")
    if not ref.endswith("_coadd_red.fits.fz"):
        raise AssertionError(f"the driver's reference is {ref}")
    r4 = pipe.process_file(p4)
    check_visit(r4, "fourth visit against the co-add", card,
                keys=("S-P", "A-P", "PC-P", "TRANS-P"))
    h4 = r4.header
    fr = float(h4["Z-FRATIO"])
    if abs(fr * NIGHT_SCALE - 1.0) > 0.05:
        raise AssertionError(f"Z-FRATIO {fr}, true {1 / NIGHT_SCALE}")
    trans = [p for p in r4.products if p.endswith("_red_trans.fits")][0]
    cols = next(d for d, _ in read_fits(trans) if isinstance(d, dict))
    found = check_night_transients(cols, tx4, ty4, card)
    t = {k: v * 1e3 for k, v in r4.timing.items()}
    torch.cuda.synchronize()
    counts = read_counts("co-add phase", card,
                         ("label_propagate", "median_filter",
                          "gather_slot_windows", "fft_cols_split"))
    if counts["fft_cols_split"] != 6:
        raise AssertionError(f"fft_cols_split: {counts['fft_cols_split']} "
                             "launches for 1 subtraction")
    print(f"fourth visit against the co-add ({os.path.basename(ref)}): "
          f"T-NTRANS {h4['T-NTRANS']}, {found} of {NTRANS} transients, "
          f"Z-FRATIO {fr} (true {1 / NIGHT_SCALE}), Z-DXRMS {h4['Z-DXRMS']}, "
          f"TQC-FLAG {h4.get('TQC-FLAG')}, run_subtraction "
          f"{t.get('device: run_subtraction', 0.0):.1f} ms; phase "
          f"{time.time() - t_phase:.1f} s [{card}]")
    return counts



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    # phase 1: device and build
    card = card_label()
    print(card)
    from blackbox_tpu_torch import kernels
    t0 = time.time()
    kernels.lib()
    print(f"built the CUDA kernels in {time.time() - t0:.1f} s")

    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext

    def ctx_for(geom):
        return ReduceContext.from_defaults(
            geom, "ML1", lac_params=LACosmicParams(strip_rows=176),
            det_params=DetectParams(max_sources=20000, label_iters=32))

    ctx = ctx_for(MEERLICHT)

    # phase 2: kernels against their plain versions
    results = check_kernels(card)
    torch.cuda.empty_cache()

    check_tiny(ctx_for, card)

    C, ych, xch = MEERLICHT.chan_shape
    mgen = torch.Generator(device="cuda").manual_seed(99)
    mbias = 0.5 * torch.randn((C, ych, xch), generator=mgen, device="cuda")
    mflat = 1.0 + 0.02 * torch.randn((C, ych, xch), generator=mgen,
                                     device="cuda")
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)

    # phase 3: raw -> catalog
    zero_counts()
    reduce_phase(ctx, card, mbias, mflat, xtalk)
    c3 = read_counts("raw -> catalog", card, ("label_propagate",
                                              "median_filter",
                                              "gather_slot_windows"))
    if c3["label_propagate"] != len(SEEDS):
        raise AssertionError(f"label_propagate: {c3['label_propagate']} "
                             f"launches for {len(SEEDS)} catalog frames")
    torch.cuda.empty_cache()

    # phase 4: raw -> transient catalog
    zero_counts()
    nframes = science_phase(ctx, card, mbias, mflat, xtalk)
    c4 = read_counts("raw -> transient catalog", card,
                     ("label_propagate", "median_filter",
                      "gather_slot_windows", "fft_cols_split",
                      "fused_detect"))
    # one K1 launch for the reference's catalog, then two a science
    # frame (the catalog's 32 steps, the transients' 48 in one launch),
    # none in the frame where BBTPU_PALLAS_DETECT=1 routes both to K5
    if c4["label_propagate"] != 1 + 2 * (nframes - 1):
        raise AssertionError(f"label_propagate: {c4['label_propagate']} "
                             f"launches for {nframes} science frames")
    if c4["fft_cols_split"] != 6 * nframes:
        raise AssertionError(f"fft_cols_split: {c4['fft_cols_split']} "
                             f"launches for {nframes} science frames")

    torch.cuda.empty_cache()

    # phase 5: calibration night, then raw -> catalog through K7, and K3
    zero_counts()
    nk7, first = calib_phase(ctx, card, xtalk)
    c5 = read_counts("calibration night + K7 reduction + K3 planes", card,
                     ("label_propagate", "gather_slot_windows",
                      "lacosmic_fused", "upsample_mesh"))
    if c5["lacosmic_fused"] != 3 * nk7:
        raise AssertionError(f"lacosmic_fused: {c5['lacosmic_fused']} "
                             f"iterations for {nk7} frames")
    if c5["median_filter"]:
        raise AssertionError("the use_pallas=True path launched K2")

    # phase 6: the default L.A.Cosmic beside K7, then K7 and K3 against
    # their plain versions on phase 5's inputs
    compare_default(ctx, card, xtalk, first)
    torch.cuda.empty_cache()
    results.append(check_k7(card, first.pop("k7")))
    results.append(check_k3(card, ctx, *first.pop("meshes")))
    del first
    torch.cuda.empty_cache()

    # phase 7: file -> file through the driver, TINY on the card against
    # the CPU, then a full night, its launches counted; phase 8: the
    # reference co-add in that night's tree, its launches counted
    tiny_night_phase(card)
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        c7, night = night_phase(ctx, card, root)
        c8 = coadd_phase(card, night)
        del night

    for r in results:
        r["launches"] = (c3[r["name"]] + c4[r["name"]] + c5[r["name"]]
                         + c7[r["name"]] + c8[r["name"]])
        r["file_to_file_launches"] = c7[r["name"]]
        r["coadd_phase_launches"] = c8[r["name"]]
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all [{card}]")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
