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
   steps), and the hole fill (K8) on a frame's two calls, a
   16 x 5280 x 1320 stack of closed saturated-star masks and a 10560²
   cosmic mosaic, at one round and at three, the stack median (K9)
   at the masters' cubes, and the science remap's two passes (K10) at
   ``ml1.transient``'s registration (0.05 deg, offset (3.2, -2.7),
   32-px nodes, 8 strips), each pass timed apart under
   ``torch.profiler``.  Both times come from CUDA events (K4's two
   calls, ~0.1 ms each, as the median of 25 launches each timed apart
   from an idle card and again behind a sleep kernel, ``median_ms``);
   each kernel's bound is the least time ``portbench/peaks.least_s``
   gives the bytes it must move and the operations it must do at those
   shapes (``least_ms``; K4's for each of its two calls).  The kernels'
   edge cases, and a TINY reduction on the card against the CPU, are
   ``tests/test_torch_cuda.py``'s (``-m cuda``).
3. The reduction (``make_reduce_fn``, production configuration with the
   PSF stages on) of three full MeerLICHT frames made on the card from
   three seeds.  Each frame's line (here and in phase 4's timed scene)
   states the branch its L.A.Cosmic passes took (``lacosmic_watch``:
   the windowed rounds, their nact, chunks and changed windows, or the
   dense branch).  Phase 7's night prints the live slots of its K4
   calls (``k4_calls``).
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
9. The networks and segment mode at full width (``unet_phase``,
   ``segment_phase``, ``vetnet_phase``): the trail U-Net trained on the
   card at the JAX package's defaults (300 steps of 8 synthetic 128²
   tiles), then ``segment_trails`` on phase 3's last calibrated frame
   (its injected trail included) on the card and on the CPU with the
   same parameters (probabilities within PROB_ATOL, the threshold maps
   equal outside |p - 0.5| <= PROB_ATOL, the card's binned 2640² mask
   the plain area filter of its own threshold map bit for bit, K1 in
   its area filter, and the two masks apart by at most min_area pixels
   for each pixel the two put on either side of the threshold); a
   quarter-frame streak at 5 sigma a pixel
   injected into that frame, the full-frame pass with its lines and the
   seeded segment pass as ``calibrate_detector`` runs them under
   ``detect_sat_segments`` (the full frame counts the trail once; the
   streak adds exactly one segment, with 80% of its core masked, to the
   frame's own segment count, which the trail's ghost lines set, a
   reference fault), and the two passes on the card against
   the CPU on the frame's lower-left quarter; the real/bogus CNN trained
   on the card (400 steps of 32); both networks written with the port's
   ``save_params`` (the JAX package's flax msgpack files) and read back
   with ``load_params``, bit-equal; a line saying whether flax, msgpack
   and h5py import on this machine (for information: nothing here
   needs them); then a fifth visit of phase 7's field (NTRANS new
   transients) through ``Pipeline.process_file`` with
   ``use_unet_sat=True`` and ``sat_model_path`` naming the U-Net's file
   and the CNN's parameters as read back from its file, against phase
   8's co-add: ASTA-P and SATELLITE bits; where
   the U-Net's mask sends it to QC red through S-ELOSTD (the moments
   fault of phase 7), again with the real/bogus network alone: MC-P, at
   least 16 transients, CLASS_REAL in [0, 1], ``score_transients`` on
   the card against the CPU to 1e-4 on the maps the driver scored; then, outside
   the counted run, ``orient_data``'s Lanczos route on a cut-out around
   a transient (card against CPU) and K1 at the U-Net's 2640² shape
   against its plain version.
10. The multi-device paths on one card (``multi_device_phase``), on a
   mesh of four tile shards (cuda:0 four times; every card, when there
   are more): ``lacosmic_sharded`` on phase 3's last calibrated frame
   with 400 more cosmic hits against the dense ``lacosmic``, and
   ``extract_catalog_sharded`` on it against ``extract_catalog``, bit
   for bit; ``make_batched_reduce`` of two full MeerLICHT frames on a
   2 x 1 mesh against ``make_reduce_fn`` per frame, bit for bit (K1
   twice, K2 and K4 launched); ``run_day(device_batch=2)`` of phase 7's
   TINY night on the card against its per-file run on the card
   (``night_parity``, no fallback); ``dryrun_multichip(4)``.  Each step
   prints its ms.
11. The windowed L.A.Cosmic rounds at full width (``lacosmic_phase``):
   the input phase 3's last frame gave ``lacosmic``, with phase 10's 400
   hits more, through the production parameters (windowed), the dense
   rounds (``windowed=False``), ``prescreen=True`` and ``max_cells``
   below round 1's nact (every pass dense); clean, mask and counts of
   each bit for bit the dense rounds', at least one windowed pass in
   the production run (else the phase fails: it would prove nothing);
   each run's passes (branch, nact, chunks), K2 and K4 launches and ms
   (host clock around synchronised calls, median of 3).  Then, outside
   the counted run (``window_kernels``), every 112² K4 call of the
   production run against its plain version, timed, with its bound,
   and K2 on the first call's windows stacked as the rounds stack them.
12. The driver's optional calibration branches (``knob_tiny_phase``,
   ``driver_knobs_phase``): the TINY knob night of
   tests/test_torch_wiring.py (a static bad-pixel mask and a
   non-linearity file named relative to ``cal_dir``, three darks into a
   master dark, the field grid, the first visit adopted as reference,
   the second subtracted) on the card and on the CPU, held together by
   ``night_parity.check_night``, and the resume of its second visit on
   both; then, in phase 7's tree at full width, three darks made on the
   card into a master dark (NDARK, MDMEAN at the injected rate, the
   stack's device span), phase 7's first visit again with the static
   mask, a reference-format spline file, ``correct_nonlin`` and the
   field grid (BPM-F and BAD bits, NONLIN-P, S-BKG moved by the
   correction, RADECOFF, the subtraction), and its granular resume
   (RED-REUSED, no calibration, the catalog the extraction of the
   published image bit for bit).  Each
   call's wall, device and host ms, and the phase's seconds.
13. One JSON line with the kernels' counts and times (K4's with the
   time of the same gathers by advanced indexing, ``library_ms``, and
   its 112² calls, ``window112_*``; K1's with its time at the U-Net's
   shape, ``unet_*``; each phase's launches under its own key), then
   the last line ``{"ok": true, "device": {...}}``.

The launch counts (``kernels.launches``, by wrapper name) are cleared
just before each of phases 3, 4, 5, 7's full night, 8, 9, 10, 11 and
12 and read just after it: every kernel of a phase's path must have
moved, K1 must show 1 launch per catalog frame and 2 per
science frame (its 48 transient steps are one launch), K6 6 and K10 2
per science frame in phase 4, K7 3 per frame it calibrates (it counts iterations, four CUDA
launches each) and K2 none in phase 5; K8 must show 2 launches a frame
in phase 3 and be launched in every phase that calibrates a frame (3,
4, 5, 7, 8, 9, 10 and 12); the night must show K1 3 times
(two catalogs, one subtraction) and K6 6 times, phase 8 K6 6 times
(one subtraction), phase 9 K1 twice for the U-Net passes over phase 3's
frame and, in the fifth visit, once for each U-Net, catalog and
subtraction, and K6 6 times (one subtraction), phase 10's batched
reduce K1 twice (two frames), phase 11 K2 and K4, phase 12 K1, K2, K4
and K6.  Any failure raises: the script then exits non-zero and prints
no ok line.  It needs a CUDA device, the repository's port package,
``portbench/peaks.py`` and the ``tests/night_parity.py`` helper.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from blackbox_tpu_torch import kernels
from portbench import peaks
from portbench.frames import registration

SEEDS = (12345, 12346, 12347)
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


def median_ms(fn, reps: int = 25, busy: bool = False) -> float:
    """Median device ms of ``fn`` over ``reps`` launches after one
    warm-up, each timed by its own pair of CUDA events: a ~0.1 ms call
    timed as a mean of a few runs moves with the card's clocks (K4).
    From an idle card (the default, how the ``kernels`` line's K4 times
    have always been taken) the events also count the host's path through the
    wrapper up to the launch; with ``busy`` a sleep kernel of ~0.5 ms
    runs before each start event, so the card is still busy while the
    host queues the call and the events time the device's work only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def least_ms(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    """``peaks.least_s`` in ms: the least time the card could take for
    the work, and what bounds it.  Operations count instructions: an
    unfused min, max, multiply or add is one (the kernels contract no
    FMA)."""
    t, by = peaks.least_s(nbytes, f32_ops, i32_ops)
    return t * 1e3, by


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
        bnd = least_ms(8.0 * H * W, i32_ops=8.0 * steps * nfg)
        k1[form] = (err, ms, plain, bnd)
        print(f"K1 label_propagate {form} {H}x{W} {steps} steps "
              f"({nfg / (H * W):.6f} of pixels set): bit-exact, kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms, "
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
        # in and out
        ops, _, _ = filters.tile_median_ops(k, th, tw)
        per_px = filters.comparator_cost(ops) / (th * tw)
        tb[k] = least_ms(8.0 * H * W, f32_ops=per_px * H * W)
        print(f"K2 median_filter k={k} {H}x{W} (and with "
              f"{int(torch.isnan(holes).sum())} NaN pixels): bit-exact, "
              f"kernel {t[k]:.3f} ms, plain {tp[k]:.3f} ms, bound "
              f"{tb[k][0]:.3f} ms ({tb[k][1]}; {per_px:g} min/max a pixel) "
              f"[{card}]")
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
    call_bounds, call_library, call_busy = [], [], []
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
        tk = median_ms(lambda: windows.gather_slot_windows(
            (img, seg), y0, x0, size, n_active=nact))
        tpl = median_ms(lambda: windows._gather_plain((img, seg), y0, x0,
                                                      size, nact))
        # the library's form of the same gathers: advanced indexing of
        # each frame on precomputed, clamped (N, S, S) index grids
        # (every slot, in-frame only: no fill, no n_active)
        ar = torch.arange(size, device="cuda")
        iy = (y0[:, None, None] + ar[None, :, None]).clamp(0, H - 1)
        ix = (x0[:, None, None] + ar[None, None, :]).clamp(0, W - 1)
        tlib = median_ms(lambda: (img[iy, ix], seg[iy, ix]))
        del iy, ix
        lib += tlib
        call_library.append(tlib)
        ms, plain = ms + tk, plain + tpl
        # 8 B a window pixel (f32 + int32): read for the live slots,
        # written for every slot
        call_bytes = 8.0 * size * size * (int(nact) + N)
        nbytes += call_bytes
        cb = least_ms(call_bytes)
        call_bounds.append(cb[0])
        # the device's time alone: a sleep kernel keeps the card busy
        # while the host queues the call
        busy = median_ms(lambda: windows.gather_slot_windows(
            (img, seg), y0, x0, size, n_active=nact), busy=True)
        call_busy.append(busy)
        print(f"K4 gather_slot_windows {N}x{size}^2 (f32 + int32, "
              f"n_active {int(nact)}): bit-exact, kernel {tk:.4f} ms from "
              f"an idle card, {busy:.4f} ms behind a sleep kernel "
              f"({cb[0] / tk:.1%} / {cb[0] / busy:.1%} of the bound), "
              f"plain {tpl:.3f} ms, library (frame[iy, ix] of both frames) "
              f"{tlib:.3f} ms (each the median of 25 launches), bound "
              f"{cb[0]:.4f} ms ({cb[1]}) [{card}]")
    results.append(dict(entry("gather_slot_windows",
                              "blackbox_tpu_torch/csrc/gather.cu",
                              "blackbox_tpu/pallas/gather.py:61", err, ms,
                              plain, *least_ms(nbytes), library_ms=lib),
                        call_bound_ms=call_bounds,
                        call_library_ms=call_library,
                        call_busy_ms=call_busy))
    results.append(check_fft(card))
    results.append(check_detect(card, img))
    del img, seg
    torch.cuda.empty_cache()
    results.append(check_fill_holes(card))
    torch.cuda.empty_cache()
    results.append(check_stack_median(card))
    torch.cuda.empty_cache()
    results.append(check_warp(card))
    return results


@contextlib.contextmanager
def k4_calls(keep_args: bool):
    """Every ``gather_slot_windows`` call the port's ops make inside the
    block, recorded in the yielded list as (N, size, images, n_active)
    and, with ``keep_args``, the call's (images, y0, x0)."""
    from blackbox_tpu_torch.ops import (cosmics, detection, photometry, psf,
                                        transients, windows)
    calls = []
    orig = windows.gather_slot_windows

    def keep(images, y0, x0, size, n_active=None):
        imgs = tuple(images) if isinstance(images, (tuple, list)) \
            else (images,)
        calls.append((y0.shape[0], size, len(imgs), n_active,
                      (imgs, y0, x0) if keep_args else None))
        return orig(images, y0, x0, size, n_active=n_active)

    mods = (cosmics, detection, photometry, psf, transients)
    for m in mods:
        m.gather_slot_windows = keep
    try:
        yield calls
    finally:
        for m in mods:
            m.gather_slot_windows = orig


def k4_live(calls, label, card):
    """Print the live share of each kind of recorded K4 call."""
    by = {}
    for N, size, nimg, n_active, _ in calls:
        live = N if n_active is None else int(n_active)
        by.setdefault((N, size, nimg), []).append(live)
    for (N, size, nimg), live in sorted(by.items()):
        print(f"K4 calls in {label}: {N}x{size}^2, {nimg} image(s): "
              f"{len(live)} calls, live slots {min(live)}-{max(live)} of "
              f"{N} ({min(live) / N:.1%}-{max(live) / N:.1%}) [{card}]")


@contextlib.contextmanager
def lacosmic_watch(keep_input: bool = False):
    """What the default L.A.Cosmic does inside the block: the yielded
    dict's "passes" gets, when the block ends, each windowed pass's
    attributes (nact, the branch taken, chunks, windows gathered,
    changed windows), read from the program's ``lacosmic.pass`` spans
    under ``utils.timing.recording``; with ``keep_input`` its "input" a
    copy, on the card, of the (data, inmask, rdnoise) of the last call
    ``calibrate_detector`` made."""
    from blackbox_tpu_torch.pipeline import reduce
    from blackbox_tpu_torch.utils.timing import recording
    seen = {"passes": [], "input": None}
    orig_lac = reduce.lacosmic

    def watch_lac(data, inmask, rdnoise, params, *a, **k):
        seen["input"] = (data.clone(), inmask.clone(),
                         torch.as_tensor(rdnoise).clone())
        return orig_lac(data, inmask, rdnoise, params, *a, **k)

    if keep_input:
        reduce.lacosmic = watch_lac
    try:
        with recording() as rec:
            yield seen
        spans, _ = rec.drain()
        seen["passes"].extend(s.attrs for s in spans
                              if s.name == "lacosmic.pass")
    finally:
        reduce.lacosmic = orig_lac


def lac_rounds(passes) -> str:
    """One frame's L.A.Cosmic rounds as text: each windowed pass's
    branch and nact (round 1 is a dense detection and the first pass
    its clean, unless the pre-screen places it)."""
    if not passes:
        return "L.A.Cosmic: no windowed pass"
    return "L.A.Cosmic passes: " + ", ".join(
        f"{q['branch']} (nact {q['nact']}, {q['chunks']} chunks, "
        f"{q['changed']} changed)" for q in passes)


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
              f"bit-exact, kernel {ms[-1]:.3f} ms, plain {plain[-1]:.3f} ms "
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
        print(f"K6 {key} launch: {got} [{card}]")
    lib = cuda_ms(lambda: torch.fft.fft(torch.complex(xr, xi), dim=0))
    # two planes in, two out; step A: the DFT_N2's instructions a
    # point, as the kernel shares them (dft_ops), and a twiddle; then k
    # radix-2 stages of an add/sub and a twiddle per point
    pts = float(N) * L
    ops = pts * (dft_ops(N2) / N2 + 6.0) + pts * k * 8.0
    bnd = least_ms(16.0 * pts, f32_ops=ops)
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
        b = least_ms(bpp * H * W, f32_ops=flops * H * W,
                  i32_ops=8.0 * args[5] * nfg)
        ms, plain, bnd_ms = ms + tk, plain + tpl, bnd_ms + b[0]
        bound_by = b[1] if b[1] == "operations" else bound_by
        forms_ms[form] = tk
        print(f"K5 fused_detect {form} form {H}x{W} ({args[5]} steps, "
              f"{nfg} pixels detected): bit-exact, kernel {tk:.3f} ms, "
              f"plain {tpl:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) [{card}]")
    return dict(entry("fused_detect", "blackbox_tpu_torch/csrc/detect.cu",
                      "blackbox_tpu/pallas/detect.py:64", err, ms, plain,
                      bnd_ms, bound_by),
                detection_ms=forms_ms["detection"],
                transient_ms=forms_ms["transient"])



def saturation_stack(C, H, W, gen):
    """The mask stage's hole-fill input: C channels of saturated stars
    (cores, rings around a hole, bleed columns), closed as
    ``satcon_close_fill`` closes them (tests/test_torch_cuda.py's
    channel-stack case)."""
    from blackbox_tpu_torch.ops import morphology as M
    dev = gen.device
    stars = torch.rand((C, H, W), generator=gen, device=dev) < 3e-5
    rings = torch.rand((C, H, W), generator=gen, device=dev) < 1e-5
    sat = M.binary_dilation(stars, size=9)
    sat |= (M.binary_dilation(rings, size=17)
            & ~M.binary_dilation(rings, size=11))
    bleed = stars & (torch.rand(stars.shape, generator=gen, device=dev)
                     < 0.3)
    sat |= torch.nn.functional.max_pool2d(
        bleed.view(C, 1, H, W).float(), (61, 3), stride=1,
        padding=(30, 1)).view(C, H, W) > 0.5
    return M._erode3(M._dilate3(M._dilate3(sat)))


def cosmic_mosaic(H, W, gen):
    """The cosmic-mask call's input: small hits, some of them rings
    around one pixel (tests/test_torch_cuda.py's mosaic case)."""
    from blackbox_tpu_torch.ops import morphology as M
    dev = gen.device
    hits = torch.rand((H, W), generator=gen, device=dev) < 8e-6
    rings = torch.rand((H, W), generator=gen, device=dev) < 2e-6
    return M.binary_dilation(hits) | (M.binary_dilation(rings) & ~rings)


def check_fill_holes(card):
    """K8 against the plain hole fill on the card, bit for bit, on a
    frame's two calls: the closed saturation stack (16 x 5280 x 1320)
    and the cosmic mosaic (10560²), at the reduction's one round and at
    the default three.  The entry's times are one of each call at one
    round, as a frame runs them."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import morphology as M

    gen = torch.Generator(device="cuda").manual_seed(16)
    masks = {"channel stack": saturation_stack(*MEERLICHT.chan_shape, gen),
             "mosaic": cosmic_mosaic(*MEERLICHT.red_shape, gen)}
    err, calls = 0.0, {}
    for name, m in masks.items():
        for rounds in (1, 3):
            got = M.fill_holes(m, rounds)
            want = M._fill_holes(m, rounds)
            err = max(err, max_abs_err(got, want))
            filled = int((want & ~m).sum())
            del got, want
            tk = cuda_ms(lambda: M.fill_holes(m, rounds), reps=20)
            tpl = cuda_ms(lambda: M._fill_holes(m, rounds), reps=1)
            # the bool mask read once and the result written once
            b = least_ms(2.0 * m.numel())
            calls[name, rounds] = (tk, tpl, b[0])
            print(f"K8 fill_holes {name} {'x'.join(map(str, m.shape))} "
                  f"{rounds} round{'s' if rounds > 1 else ''} ({filled} "
                  f"pixels filled): bit-exact, kernel {tk:.4f} ms, plain "
                  f"{tpl:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
    one = [calls[name, 1] for name in masks]
    return dict(entry("fill_holes", "blackbox_tpu_torch/csrc/fillholes.cu",
                      "none (blackbox_tpu/ops/morphology.py:155, XLA)", err,
                      sum(c[0] for c in one), sum(c[1] for c in one),
                      sum(c[2] for c in one), "bytes"),
                call_ms=[c[0] for c in one],
                call_plain_ms=[c[1] for c in one],
                call_bound_ms=[c[2] for c in one],
                three_rounds_ms=[calls[name, 3][0] for name in masks])


def check_stack_median(card):
    """K9 against the sort route on the card, bit for bit, at the
    masters' cubes: a 20-deep bias and a 15-deep flat of the channel
    stacks (16 x 5280 x 1320), one NaN pixel each; then the sign K9
    gives a median of columns that mix -0.0 and +0.0 (the sort route's
    there is the order torch.sort leaves equal keys in).  The entry's
    times are the bias's and the flat's."""
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import filters, stats

    gen = torch.Generator(device="cuda").manual_seed(21)
    err, calls = 0.0, {}
    for name, n in (("bias", 20), ("flat", 15)):
        x = torch.randn((n, *MEERLICHT.chan_shape), generator=gen,
                        device="cuda")
        x.mul_(5.0).add_(1000.0)
        x[n // 2, 3, 17, 5] = float("nan")
        got = stats.median(x, axis=0)
        want = stats._median_sort(x, 0)
        err = max(err, max_abs_err(got, want))
        nan = torch.isnan(want)
        if not bool(((got.view(torch.int32) == want.view(torch.int32))
                     | nan).all()):
            raise AssertionError(f"K9 {name}: bits differ from the sort")
        del got, want, nan
        tk = cuda_ms(lambda: stats.median(x, axis=0), reps=20)
        tpl = cuda_ms(lambda: stats._median_sort(x, 0), reps=3)
        m = x[0].numel()
        # the stack read once and the medians written once; the network
        # and the NaN test a column
        ops = m * (filters.comparator_cost(filters.stack_median_ops(n)[0])
                   + n)
        b = least_ms(4.0 * (n + 1) * m, f32_ops=ops)
        calls[name] = (tk, tpl, b[0])
        print(f"K9 stack_median {name} {'x'.join(map(str, x.shape))}: "
              f"bit-exact, kernel {tk:.4f} ms ({100 * b[0] / tk:.1f}% of "
              f"its bound), sort {tpl:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) "
              f"[{card}]")
        del x
        torch.cuda.empty_cache()
    signs = {}
    for n in (2, 3, 20):
        x = torch.where(torch.rand((n, 4096), generator=gen, device="cuda")
                        < 0.5, -0.0, 0.0)
        got, want = stats.median(x, axis=0), stats._median_sort(x, 0)
        if not bool((got == want).all()):
            raise AssertionError("K9 on signed zeros differs from the sort")
        signs[n] = (int(torch.signbit(got).sum()),
                    int(torch.signbit(want).sum()))
    print(f"K9 on columns of -0.0 and +0.0 (N: medians -0.0 by K9, by the "
          f"sort, of 4096): {signs} [{card}]")
    return dict(entry("stack_median", "blackbox_tpu_torch/csrc/stackmedian.cu",
                      "none (blackbox_tpu/pipeline/masters.py:29, jnp.median)",
                      err, sum(c[0] for c in calls.values()),
                      sum(c[1] for c in calls.values()),
                      sum(c[2] for c in calls.values()), "bytes"),
                call_ms=[c[0] for c in calls.values()],
                call_plain_ms=[c[1] for c in calls.values()],
                call_bound_ms=[c[2] for c in calls.values()],
                signed_zeros=signs)


def k10_ops(H, W, ranges):
    """Float operations of csrc/warp.cu's two passes over an (H, W)
    frame in the (sy, sx, step) form with per-strip ``ranges``: each
    shift of a pixel's strip 25 (k's conversion, ds, the numerator's 5,
    pi * ds and its square, |ds|, the NaN test and max, the tap test and
    select, the IEEE division's 6 on its fast path: a reciprocal, four
    fused multiply-adds and a check, the range test and select, the norm
    and the plane's multiply-add); each pixel a pass 3 transcendentals,
    counted as one instruction each (their least), and 28 more (pass 1:
    the lerp of ys from the nodes 13, d 2, d0, pi * d0 and / a 4, the
    norm's test and select and the division 8, rint 1), 24 more in pass
    2 (the lerp of xs, and the two in-frame tests)."""
    ry, rx = ranges

    def shifts(r, n_perp, n_along):
        B = len(r)
        return sum((((b + 1) * n_perp) // B - (b * n_perp) // B) * n_along
                   * max(r1 - r0 + 1, 0) for b, (r0, r1) in enumerate(r))

    per_shift, pixel1, pixel2 = 25, 3 + 28, 3 + 28 + 24
    return float(per_shift * (shifts(ry, W, H) + shifts(rx, H, W))
                 + (pixel1 + pixel2) * H * W)


def check_warp(card):
    """K10 against the plain route on the card, bit for bit, on the
    science remap of ``ml1.transient``: a background-subtracted star
    field (Lanczos), its noise map and a sparse uint8 mask (nearest),
    the fills (0, a device scalar, EDGE), 8 strips of 32-px nodes; each
    pass's device time apart.  The bound is the larger of the two-pass
    form's bytes (36 a pixel: the three planes read, written as
    intermediates, read again and written as results; the coordinates
    come from the coarse nodes) and its float operations
    (:func:`k10_ops`)."""
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops import warp

    H, W = MEERLICHT.red_shape
    gen = torch.Generator(device="cuda").manual_seed(23)
    img = star_field(H, W, gen) - 300.0
    std = 5.0 + torch.rand((H, W), generator=gen, device="cuda")
    msk = (torch.rand((H, W), generator=gen, device="cuda") < 0.02).to(
        torch.uint8) * maskbits.SATURATED
    sy, sx, _ = registration((H, W), 0.05, (3.2, -2.7), 32)
    ranges = warp.grid_shift_ranges(sy, sx, step=32, blocks=8)
    args = ((img, std, msk), ("lanczos", "nearest", "nearest"),
            (0.0, torch.median(std), maskbits.EDGE),
            (torch.from_numpy(sy).cuda(), torch.from_numpy(sx).cuda(), 32),
            ranges)
    before = kernels.launches["warp_pass"]
    got = warp.warp_shift2pass(*args)
    if kernels.launches["warp_pass"] != before + 2:
        raise AssertionError("the science remap did not run K10's two "
                             "passes")
    want = warp._shift2pass_plain(*args)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise AssertionError("K10: bits differ from the plain route")
    filled = int((want[2] & maskbits.EDGE).sum())
    del got, want
    tk = cuda_ms(lambda: warp.warp_shift2pass(*args), reps=20)
    tpl = cuda_ms(lambda: warp._shift2pass_plain(*args), reps=3)
    passes = {k: ms for name, (ms, _)
              in device_times(lambda: warp.warp_shift2pass(*args)).items()
              for k in ("warp_rows", "warp_cols") if k in name}
    b = least_ms(36.0 * H * W, k10_ops(H, W, ranges))
    print(f"K10 warp_pass {H}x{W}, 3 planes, ranges {ranges}: bit-exact "
          f"({filled} pixels filled EDGE), kernel {tk:.3f} ms "
          f"({100 * b[0] / tk:.1f}% of its bound; passes "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items())
          + f"), plain {tpl:.3f} ms, bound {b[0]:.4f} ms ({b[1]}); 2 "
          f"launches a science frame [{card}]")
    return dict(entry("warp_pass", "blackbox_tpu_torch/csrc/warp.cu",
                      "none (blackbox_tpu/ops/warp.py, XLA)", err, tk, tpl,
                      *b), pass_ms=passes)


def k7_ops():
    """Float operations of csrc/lacosmic.cu: (dense per pixel and
    iteration, per pixel listed for the 7x7 median, per pixel listed for
    the masked clean).  Stages 1 and 2 take their
    5x5 and 3x3 medians from K2's tile programs (the min/max of
    ``tile_median_ops`` over the tile's pixels); stage 1 adds the
    Laplacian and noise model, stage 2 sp and its gt test, then the two
    dilations and their gt tests; a listed 7x7 median runs the
    sorted-column network (a column sort, one column a pixel, and the
    pruned merge) and adds f and the seed mask's second gt test, a
    listed clean the 25-value transposition sort, the blend and good
    count, and the two 25-term rank picks."""
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
    return float(dense), float(med7), float(clean)


def check_k7(card, args):
    """K7 on the call the reduction made in phase 5 (``args``: the
    calibrated mosaic, its mask, read noise, sigclip, sigfrac, objlim
    and niter), bit-exact against its plain version at that full shape
    and timed there.  Its bound counts the operations these inputs need
    (the dense stages everywhere, the 7x7 median and the clean on the
    pixels the kernel listed)."""
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
    dense, med7, clean = k7_ops()
    n7 = sum(c[0] for c in listed)
    nc = sum(c[1] for c in listed)
    ops = niter * dense * Hp * Wp + med7 * n7 + clean * nc
    # f32 frame and bool inmask in, f32 clean and bool crmask out
    bnd = least_ms(10.0 * H * W, f32_ops=ops)
    print(f"K7 lacosmic_fused {H}x{W} (padded {Hp}x{Wp}), {niter} iterations "
          f"({nflag} pixels flagged; listed for the 7x7 median / the clean "
          f"by iteration: {listed}): bit-exact, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}, "
          f"{ops / (niter * Hp * Wp):.2f} ops/px/iteration: {dense:g} "
          f"dense, {med7:.0f} a listed 7x7 median, {clean:.0f} a listed "
          f"clean) [{card}]")
    return dict(entry("lacosmic_fused", "blackbox_tpu_torch/csrc/lacosmic.cu",
                      "blackbox_tpu/pallas/lacosmic.py:120", err, ms, plain,
                      *bnd),
                listed=listed)


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
    bnd = least_ms(4.0 * (H * W + H * ny + W * nx + ny * nx),
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


def launch_counts():
    """Every kernel's launches since the last ``kernels.launches.clear()``,
    by wrapper name."""
    return {name: kernels.launches[name] for name in kernels.LAUNCHERS}


def read_counts(label, card, needed):
    """The counts of the path just run; every kernel in ``needed`` must
    have been launched."""
    counts = launch_counts()
    print(f"{label} launches {counts} [{card}]")
    for name in needed:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on {label}")
    return counts


def check_frame(out, ctx, label, ms, card, lac=None):
    """A full frame's outputs and the gates of the raw -> catalog path:
    nobjects 3000..5000 (4020 sources injected), cosmics and a trail
    found, a finite PSF.  ``lac``: the frame's L.A.Cosmic passes
    (``lacosmic_watch``), printed."""
    check_outputs(out, ctx, label)
    st = out["stats"]
    nobj, ncr, nsat = (int(st["nobjects"]), int(st["ncosmics"]),
                       int(st["nsats"]))
    fwhm = float(st["psf_fwhm_pix"])
    print(f"{label}: {ms:.1f} ms, nobjects {nobj}, ncosmics {ncr}, nsats "
          f"{nsat}, seeing {float(st['s_seeing_pix']):.2f} px, PSF "
          f"{int(st['psf_nstars'])} stars, FWHM {fwhm:.2f} px, elongation "
          f"STD {float(st['s_elostd']):.2f} (QC red above 10)"
          f"{'' if lac is None else '; ' + lac_rounds(lac)} [{card}]")
    if not 3000 <= nobj <= 5000:
        raise AssertionError(f"{label}: nobjects {nobj} outside "
                             "3000..5000 (4020 sources injected)")
    if ncr <= 0 or nsat < 1:
        raise AssertionError(f"{label}: ncosmics {ncr}, nsats {nsat}")
    if not np.isfinite(fwhm):
        raise AssertionError(f"{label}: PSF FWHM {fwhm}")


def reduce_phase(ctx, card, mbias, mflat, xtalk):
    """Phase 3: three full MeerLICHT frames through make_reduce_fn.
    Returns the last frame's calibrated image and mask, on the host, for
    phase 9, and the (data, inmask, rdnoise) its L.A.Cosmic call got,
    for phase 11."""
    from blackbox_tpu_torch.pipeline.reduce import make_reduce_fn
    from blackbox_tpu_torch.synth.device import make_science_device

    geom = ctx.geom
    fn = make_reduce_fn(ctx)
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    kept = None
    for i, seed in enumerate(SEEDS):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        chan, osv, osh, _ = make_science_device(
            gen, geom, nstars=4000, ncosmics=800, trail=True, nsat=20)
        torch.cuda.synchronize()
        with lacosmic_watch(keep_input=i == len(SEEDS) - 1) as lac:
            t0 = time.perf_counter()
            out = fn(chan, osv, osh, mbias, mflat, None, xtalk)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        check_frame(out, ctx, f"frame {i} (seed {seed}"
                    f"{', warm-up' if i == 0 else ''})", ms, card,
                    lac["passes"])
        frame_ms.append(ms)
        if i == len(SEEDS) - 1:
            kept = (out["image"].cpu(), out["mask"].cpu())
            lac_input = tuple(x.cpu() for x in lac["input"])
        del out, chan, osv, osh
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = frame_ms[1:]
    print(f"raw -> catalog: {sum(steady) / len(steady):.1f} ms/frame steady "
          f"(frames {', '.join(f'{m:.1f}' for m in steady)} ms after a "
          f"{frame_ms[0]:.1f} ms warm-up), peak memory {peak_gib:.2f} GiB "
          f"[{card}]")
    return kept, lac_input


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
        with lacosmic_watch() as lac:
            t0 = time.perf_counter()
            f = front(chan, *args)
            b = back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"],
                     f["cat"], f["stats"]["bkg_std"], ref["sub"],
                     ref["std"], ref["mask"], (sy, sx), ref["psf"],
                     ref["sr"], cat_t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        nframes += 1
        ts = b["trans_stats"]
        print(f"science frame {i}{' (warm-up)' if i == 0 else ''}: "
              f"{times[-1]:.1f} ms raw -> transient catalog, z_fratio "
              f"{float(ts['z_fratio']):.4f}, z_nmatch {int(ts['z_nmatch'])},"
              f" t_ntrans {int(ts['t_ntrans'])}; "
              f"{lac_rounds(lac['passes'])} [{card}]")
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
    k5 = kernels.launches["fused_detect"]
    os.environ["BBTPU_PALLAS_DETECT"] = "1"
    try:
        n1, b1 = gated()
    finally:
        del os.environ["BBTPU_PALLAS_DETECT"]
    nframes += 1
    if kernels.launches["fused_detect"] < k5 + 2:
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


def tiny_night_phase(card, base):
    """Phase 7, first part: the TINY night of tests/test_torch_driver.py
    through the port's Pipeline on the card and on the CPU (plain
    versions), each in its own copy of the raw tree, held together by
    tests/night_parity.py: statuses, product names, keywords and flags,
    masks bit for bit, images, catalogs and transients at the tier-1
    parity tolerances.  Quicklooks are off: this machine has no PIL
    (tier-1 covers them on the CPU).  The raw tree and the card's run
    stay under ``base`` for phase 10, which gets (card run, raw files,
    stars)."""
    import shutil
    NP = night_parity()
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline

    files, stars = NP.tiny_night(os.path.join(base, "raw"))
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                          create_ref=True, make_quicklooks=False)
    runs = {}
    for device in ("cuda", "cpu"):
        root = os.path.join(base, device)
        shutil.copytree(os.path.join(base, "raw"), root)
        pipe = Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                        ref_catalog=NP.ref_catalog(stars, TINY.red_shape),
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
    return gpu, files, stars


def night_parity():
    """tests/night_parity.py, the night and its comparisons (jax-free)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import night_parity as NP
    return NP


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
    kernels.launches.clear()
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
                          "gather_slot_windows", "fft_cols_split",
                          "fill_holes"))
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
                        files=files,
                        res=res, truth=truth, wcs1=wcs1, write=write,
                        trans=(tx, ty), query=query)


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
        raise AssertionError(f"{label}: QC red, " + ", ".join(
            f"{k} {h[k]}" for k in h.keys() if k.startswith("QCRED")))
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
    phase and the fourth visit's timing spans."""
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
    kernels.launches.clear()

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

    before = launch_counts()
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
    moved = {k: n - before[k] for k, n in launch_counts().items()}
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
                          "gather_slot_windows", "fft_cols_split",
                          "fill_holes"))
    if counts["fft_cols_split"] != 6:
        raise AssertionError(f"fft_cols_split: {counts['fft_cols_split']} "
                             "launches for 1 subtraction")
    print(f"fourth visit against the co-add ({os.path.basename(ref)}): "
          f"T-NTRANS {h4['T-NTRANS']}, {found} of {NTRANS} transients, "
          f"Z-FRATIO {fr} (true {1 / NIGHT_SCALE}), Z-DXRMS {h4['Z-DXRMS']}, "
          f"TQC-FLAG {h4.get('TQC-FLAG')}, run_subtraction "
          f"{t.get('device: run_subtraction', 0.0):.1f} ms; phase "
          f"{time.time() - t_phase:.1f} s [{card}]")
    return counts, r4.timing



# ---------------------------------------------------------------- phase 9

# synth/device.py's satellite trail: the line through (0.1 W, 0.2 H) and
# (0.9 W, 0.8 H), Gaussian profile of sigma 3 / 2.355 px
TRAIL = ((0.1, 0.2), (0.9, 0.8))
TRAIL_SIGMA = 3.0 / 2.355
# the quarter-frame streak of the segment mode: its ends (x, y) as
# fractions of the frame, (1500, 6500) -> (4000, 7500) px at 10560²,
# at STREAK_SNR sigma a pixel on its core
STREAK = ((1500 / 10560, 6500 / 10560), (4000 / 10560, 7500 / 10560))
STREAK_SNR = 5.0
FIFTH_SHIFT = (-3, 2)   # (dx, dy) px of the fifth visit's pointing
# the U-Net's probabilities, card against CPU (float32 convolutions by
# other algorithms; 0.97e-4 to 1.06e-4 in eight trainings on one H100)
PROB_ATOL = 5e-4


def line_distance(shape, p0, p1, device):
    """Distance in px of every pixel from the line through ``p0`` and
    ``p1`` ((x, y) px), and its position along it (0 at p0, 1 at p1)."""
    H, W = shape
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    (x0, y0), (x1, y1) = p0, p1
    L = math.hypot(x1 - x0, y1 - y0)
    ux, uy = (x1 - x0) / L, (y1 - y0) / L
    d = torch.abs((xx - x0) * uy - (yy - y0) * ux)
    along = ((xx - x0) * ux + (yy - y0) * uy) / L
    return d, along


def synced(fn):
    """``fn()`` and its host ms around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def unet_phase(card, image, mask):
    """Phase 9, first part: the trail U-Net trained on the card at the
    JAX package's defaults, then segment_trails on phase 3's last
    calibrated frame (its injected trail included) on the card and on
    the CPU with the same parameters.  Returns the parameters and the
    card's binned probabilities."""
    from blackbox_tpu_torch.models import trailnet
    t0 = time.time()
    params = trailnet.train(device="cuda", log_every=299)
    torch.cuda.synchronize()
    print(f"U-Net trained on the card: 300 steps of 8 synthetic 128² "
          f"tiles in {time.time() - t0:.1f} s (the first and last loss "
          f"above) [{card}]")
    cfg = trailnet.TrailNetConfig()
    f = cfg.bin_factor
    img = image.cuda()
    trailnet.segment_trails(params, img)            # warm-up
    (m_card, n_card), ms = synced(lambda: trailnet.segment_trails(params,
                                                                  img))
    from scipy import ndimage
    prob = trailnet.trail_probability(params, img)
    Hb, Wb = prob.shape
    t0 = time.time()
    m_cpu, n_cpu = trailnet.segment_trails(params, image)
    cpu_s = time.time() - t0
    prob_cpu = trailnet.trail_probability(params, image)
    dp = float((prob.cpu() - prob_cpu).abs().max())
    if dp > PROB_ATOL:
        raise AssertionError(f"U-Net: probabilities {dp:.3g} apart between "
                             f"the card and the CPU (tolerance {PROB_ATOL})")
    # the threshold maps may differ only where a probability lies within
    # PROB_ATOL of the threshold
    t_card = (prob > cfg.threshold).cpu()
    t_cpu = prob_cpu > cfg.threshold
    near = (prob_cpu - cfg.threshold).abs() <= PROB_ATOL
    flip = t_card != t_cpu
    if bool((flip & ~near).any()):
        raise AssertionError("U-Net: threshold maps differ outside "
                             f"|p - 0.5| <= {PROB_ATOL}")
    # the card's mask is the plain area filter of its own threshold map
    # bit for bit (K1 on the real map); the CPU's mask is that of its
    # own, so the two masks differ only through the flipped pixels:
    # each moves itself and at most a fragment under min_area pixels
    b_card = m_card[:Hb * f:f, :Wb * f:f].cpu()
    b_cpu = m_cpu[:Hb * f:f, :Wb * f:f]
    want = trailnet.area_filter(t_card, cfg.min_area)
    if not torch.equal(b_card, want):
        raise AssertionError(
            f"U-Net: the card's mask differs from the plain area filter of "
            f"its threshold map at {int((b_card != want).sum())} pixels")
    nflip, nnear = int(flip.sum()), int(near.sum())
    ndiff = int((b_card != b_cpu).sum())
    if ndiff > nflip * cfg.min_area:
        raise AssertionError(f"U-Net: masks apart at {ndiff} binned pixels "
                             f"from {nflip} flipped ones (min_area "
                             f"{cfg.min_area})")
    # the 8-connected regions of either threshold map that hold a
    # flipped pixel, and the injected trail's binned core within them
    lab, _ = ndimage.label((t_card | t_cpu).numpy(), np.ones((3, 3), bool))
    moved = torch.from_numpy(np.isin(lab, lab[flip.numpy()]) & (lab > 0))
    # the binned pixels of the last, partly padded row and column of
    # tiles: each such tile is normalised by its own median and MAD,
    # which its zero padding dominates
    T = cfg.tile
    strip = torch.ones((Hb, Wb), dtype=torch.bool)
    strip[:Hb // T * T, :Wb // T * T] = False
    in_strip = int((b_card & strip).sum())
    H, W = image.shape
    (x0, y0), (x1, y1) = TRAIL
    d, _ = line_distance((H, W), (x0 * W, y0 * H), (x1 * W, y1 * H),
                         m_card.device)
    core = d < TRAIL_SIGMA
    share = float((m_card & core).sum()) / float(core.sum())
    core_b = core[:Hb * f:f, :Wb * f:f].cpu()
    trail_moved = int((core_b & moved).sum())
    del d, core, img
    print(f"U-Net segment_trails {H}x{W} (binned {Hb}x{Wb}, "
          f"{-(-Hb // cfg.tile)}x{-(-Wb // cfg.tile)} tiles of "
          f"{cfg.tile}²): card {ms:.1f} ms, CPU {cpu_s:.1f} s; binned "
          f"pixels masked {int(n_card)} (CPU {int(n_cpu)}), probabilities "
          f"within {dp:.3g}; threshold maps apart at {nflip} binned pixels "
          f"({nnear} within {PROB_ATOL} of 0.5), the card's mask its plain "
          f"area filter bit for bit, masks apart at {ndiff} pixels (at most "
          f"{nflip * cfg.min_area}); the regions holding a flipped pixel "
          f"{int(moved.sum())} pixels, {trail_moved} of the injected "
          f"trail's {int(core_b.sum())} binned core pixels; {in_strip} "
          f"masked in the partly padded last row and column of tiles "
          f"({int(strip.sum())} binned pixels); the injected trail's core "
          f"covered {share:.3f}; mask pixels (full res) "
          f"{int(m_card.sum())} [{card}]")
    return params, prob


def segment_phase(card, ctx, image, mask):
    """Phase 9, second part: the full-frame pass with its lines and the
    seeded segment pass, as calibrate_detector runs them under
    detect_sat_segments, on phase 3's frame, then with a quarter-frame
    streak at STREAK_SNR sigma a pixel injected beside its full trail;
    then the two passes on the card against the CPU on the frame's cut
    that holds the streak.  The segment pass counts the frame's own
    diagonal trail again through ghost lines, a fault of the reference
    that the port matches (tests/test_torch_satdet.py::
    test_diagonal_trail_ghost_count_fault): the streak must add exactly
    one segment to that count."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import night_parity as NP
    from blackbox_tpu_torch.ops import satdet
    from blackbox_tpu_torch.ops.stats import median
    from blackbox_tpu_torch.pipeline.reduce import trail_exclusion

    img = image.cuda()
    H, W = img.shape
    excl, srows, scols = trail_exclusion(ctx.geom, mask.cuda())
    p = ctx.sat_params
    _, n0, _, lines0 = satdet.detect_trails(
        img, excl, p, seam_rows=srows, seam_cols=scols, want_lines=True)
    _, base, _ = satdet.detect_trail_segments(
        img, excl, p, seam_rows=srows, seam_cols=scols, exclude_lines=lines0)
    n0, base = int(n0), int(base)
    sub = img[::16, ::16]
    sigma = float(1.4826 * median((sub - median(sub)).abs()))
    ends = [(x * W, y * H) for x, y in STREAK]
    d, along = line_distance(img.shape, *ends, img.device)
    inside = (along >= 0) & (along <= 1)
    img += torch.where(inside, STREAK_SNR * sigma * torch.exp(
        -0.5 * (d / TRAIL_SIGMA) ** 2), 0.0)
    streak = inside & (d < TRAIL_SIGMA)
    del d, along, inside

    def passes(im, ex, rows, cols):
        m, n, snr, lines = satdet.detect_trails(
            im, ex, p, seam_rows=rows, seam_cols=cols, want_lines=True)
        sm, sn, ssnr = satdet.detect_trail_segments(
            im, ex, p, seam_rows=rows, seam_cols=cols, exclude_lines=lines)
        return m, int(n), snr, sm, int(sn), ssnr

    passes(img, excl, srows, scols)                 # warm-up
    (m, n, snr, lines), full_ms = synced(lambda: satdet.detect_trails(
        img, excl, p, seam_rows=srows, seam_cols=scols, want_lines=True))
    (sm, sn, ssnr), seg_ms = synced(lambda: satdet.detect_trail_segments(
        img, excl, p, seam_rows=srows, seam_cols=scols,
        exclude_lines=lines))
    n, sn = int(n), int(sn)
    cover = float((sm & streak).sum()) / float(streak.sum())
    print(f"segment mode on phase 3's frame alone: full frame {n0} "
          f"trail(s), segments {base} new (the trail's ghost lines, a "
          f"fault of the reference) [{card}]")
    print(f"segment mode on phase 3's frame + a {STREAK_SNR:g} sigma/px "
          f"streak ({ends[0]} -> {ends[1]} px, sigma {sigma:.2f} e-): "
          f"full frame {n} trail(s) (snr "
          f"{[round(float(v), 2) for v in snr if v > 0]}, "
          f"{int(m.sum())} px masked) in {full_ms:.1f} ms; segments {sn} "
          f"new (snr {[round(float(v), 2) for v in ssnr if v > 0]}, "
          f"{int(sm.sum())} px masked, the streak's core covered "
          f"{cover:.3f}) in {seg_ms:.1f} ms [{card}]")
    if n0 != 1 or n != 1 or sn != base + 1:
        raise AssertionError(
            f"segment mode: {n0} full-frame trail(s) on the frame and {n} "
            f"with the streak, {base} segments on the frame and {sn} with "
            "the streak: the full frame must count its trail once and the "
            "streak add one segment")
    if cover < 0.8:
        raise AssertionError(f"segment mode: the streak's core covered "
                             f"{cover:.3f}")
    # card against CPU on the cut that holds the streak
    r0, c1 = H // 2, W // 2
    cut = (slice(r0, H), slice(0, c1))
    rows = tuple(r - r0 for r in srows if r0 <= r < H)
    cols = tuple(c for c in scols if c < c1)
    got = passes(img[cut].contiguous(), excl[cut].contiguous(), rows, cols)
    t0 = time.time()
    want = passes(img[cut].cpu(), excl[cut].cpu(), rows, cols)
    cpu_s = time.time() - t0
    if (got[1], got[4]) != (want[1], want[4]):
        raise AssertionError(f"segment mode on the cut: counts "
                             f"{(got[1], got[4])} on the card, "
                             f"{(want[1], want[4])} on the CPU")
    flips = [NP.mask_edge_flips(got[i].cpu().numpy(), want[i].numpy())
             for i in (0, 3)]
    print(f"segment mode card vs CPU on the {H - r0}x{c1} cut: counts "
          f"{(got[1], got[4])} equal, masks equal but {flips} pixels on "
          f"the masks' edges; CPU {cpu_s:.1f} s [{card}]")


def same_bits(a: dict, b: dict, what: str) -> None:
    """Two state dicts with the same keys, shapes, dtypes and bits."""
    if list(a) != list(b):
        raise AssertionError(f"{what}: keys {list(a)} against {list(b)}")
    for k in a:
        x, y = a[k].detach().cpu(), b[k].detach().cpu()
        if (x.shape != y.shape or x.dtype != y.dtype
                or not torch.equal(x.view(torch.int32), y.view(torch.int32))):
            raise AssertionError(f"{what}: {k} differs")


def optional_imports() -> dict:
    """Whether flax, msgpack and h5py import here, tried in a child
    process (for information: the port needs none of them)."""
    code = ("import importlib, json\n"
            "out = {}\n"
            "for m in ('flax', 'msgpack', 'h5py'):\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "        out[m] = True\n"
            "    except Exception:\n"
            "        out[m] = False\n"
            "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    return json.loads(res.stdout.strip().splitlines()[-1])


def weight_files(card, root, unet, vparams):
    """Both networks written with the port's save_params under ``root``
    (flax msgpack, the JAX package's format) and read back with
    load_params, bit-equal.  Returns (U-Net file, CNN parameters read
    back)."""
    from blackbox_tpu_torch.models import trailnet, vetnet
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir, exist_ok=True)
    upath = os.path.join(wdir, "unet.msgpack")
    vpath = os.path.join(wdir, "vetnet.msgpack")
    t0 = time.perf_counter()
    trailnet.save_params(upath, unet)
    vetnet.save_params(vpath, vparams)
    t1 = time.perf_counter()
    unet_back = trailnet.load_params(upath)
    vback = vetnet.load_params(vpath)
    t2 = time.perf_counter()
    same_bits(unet_back, unet, "U-Net file")
    same_bits(vback, vparams, "real/bogus CNN file")
    print(f"weight files: U-Net {os.path.getsize(upath)} B and CNN "
          f"{os.path.getsize(vpath)} B written by save_params (flax "
          f"msgpack) in {(t1 - t0) * 1e3:.1f} ms, read back by load_params "
          f"bit-equal in {(t2 - t1) * 1e3:.1f} ms (host) [{card}]")
    print(f"optional packages importable here (not used): "
          f"{json.dumps(optional_imports())}")
    return upath, vback


def vetnet_phase(card, night, unet, t4, root):
    """Phase 9, third part: the real/bogus CNN trained on the card, both
    networks through their weight files (``weight_files``), then a
    fifth visit of phase 7's field (its own noise and cosmics, moved
    FIFTH_SHIFT px, NTRANS new transients) file to file through a
    Pipeline that loads the U-Net from its file (``use_unet_sat=True``,
    ``sat_model_path``) and takes the CNN as read back from its file,
    against the co-add of phase 8: ASTA-P and the U-Net's SATELLITE
    bits.  No keras file can be made here (this machine has no HDF5
    writer), so the keras route is held on the CPU in tier-1, with h5py
    blocked (tests/test_torch_weights.py).  Where the U-Net's mask sends
    the frame to QC red through S-ELOSTD (a fault of the reference), the
    same raw frame runs again with the real/bogus network alone for its
    gates: MC-P, the transients, CLASS_REAL.  The maps and candidates
    the driver scores are kept for the card-CPU check.  Returns them
    and the transients' truth."""
    from blackbox_tpu_torch.io.fits import read_fits
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.models import vetnet
    from blackbox_tpu_torch.pipeline import driver
    from blackbox_tpu_torch.synth.device import make_science_device

    t0 = time.time()
    vparams = vetnet.train(device="cuda", log_every=399)
    torch.cuda.synchronize()
    print(f"real/bogus CNN trained on the card: 400 steps of 32 synthetic "
          f"32² stamp stacks in {time.time() - t0:.1f} s [{card}]")
    upath, vparams = weight_files(card, root, unet, vparams)
    pipe0 = night["pipe"]
    geom = pipe0.geom
    H, W = geom.red_shape
    rng = np.random.default_rng(9)
    edge = min(300, H // 6)
    tx = np.floor(rng.uniform(edge, W - edge, NTRANS))
    ty = np.floor(rng.uniform(edge, H - edge, NTRANS))
    (x5, y5, f5), pointing5 = visit_stars(night["truth"], *FIFTH_SHIFT, 0.0,
                                          NIGHT_SCALE, geom)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda")
    stars5 = (torch.cat([x5, as_t(tx)]), torch.cat([y5, as_t(ty)]),
              torch.cat([f5, torch.full((NTRANS,), 3.0e4, device="cuda")]))
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[2] + 2)
    stacks = make_science_device(gen, geom, ncosmics=800, trail=False,
                                 stars=stars5)[:3]
    p5 = night["write"](stacks, "object", 10, EXPTIME,
                        *pointing5(night["wcs1"]))
    del stacks, stars5
    k1 = []

    def run(force=False, sat_model_path=None, **nets):
        """The fifth visit through a Pipeline with ``nets``, and the U-Net
        from ``sat_model_path`` where given; the maps and candidates it
        scores are kept.  K1 runs once for the catalog, once for the
        U-Net's area filter and once for the subtraction's
        transients."""
        settings = night["settings"]
        if sat_model_path is not None:
            settings = dataclasses.replace(settings, use_unet_sat=True,
                                           sat_model_path=sat_model_path)
        pipe = driver.Pipeline(night["tree"], "ML1", settings,
                               pipe0.ctx, ref_catalog=night["query"], **nets)
        if sat_model_path is not None:
            if pipe.trailnet_params is None:
                raise AssertionError(f"the driver did not load the U-Net "
                                     f"from {sat_model_path}")
            same_bits(pipe.trailnet_params, unet, "the driver's U-Net")
        seen = []
        score = vetnet.score_transients

        def keep(*args):
            seen.append(args[1:])
            return score(*args)

        before = kernels.launches["label_propagate"]
        vetnet.score_transients = keep
        try:
            r = pipe.process_file(p5, force=force)
        finally:
            vetnet.score_transients = score
        if r.status != "reduced":
            raise AssertionError(f"fifth visit: {r.status} {r.error}")
        want = (1 + (sat_model_path is not None)
                + (r.header.get("TRANS-P") is True))
        k1.append(kernels.launches["label_propagate"] - before)
        if k1[-1] != want:
            raise AssertionError(f"fifth visit: label_propagate {k1[-1]} "
                                 f"launches, {want} expected")
        return r, seen

    r1, seen = run(sat_model_path=upath, vetnet_params=vparams)
    h1 = r1.header
    mask_p = [q for q in r1.products if q.endswith("_mask.fits.fz")][0]
    nsat = int(((read_rice(mask_p)[0] & maskbits.SATELLITE) != 0).sum())
    if h1.get("ASTA-P") is not True or nsat == 0:
        raise AssertionError(f"fifth visit: ASTA-P {h1.get('ASTA-P')}, "
                             f"{nsat} SATELLITE pixels")
    reds = [str(h1[k]) for k in h1.keys() if k.startswith("QCRED")]
    print(f"fifth visit with both networks (the U-Net from its file): "
          f"ASTA-P true, {nsat} SATELLITE "
          f"pixels in the published mask, QC {r1.qc_flag} "
          f"({', '.join(reds) or 'no red keys'}), NOBJECTS "
          f"{h1.get('NOBJECTS')}, S-ELOSTD {h1.get('S-ELOSTD')} [{card}]")
    r5 = r1
    if r1.qc_flag == "red":
        # the U-Net's mask cuts stars into few-pixel fragments whose
        # moments the reference floors (ROADMAP Queue 3): S-ELOSTD sends
        # the frame to QC red and dummy catalogs, so the real/bogus gates
        # are taken on the same raw frame without the U-Net
        if reds != ["S-ELOSTD"]:
            raise AssertionError(f"fifth visit: QC red through {reds}")
        r5, seen = run(force=True, vetnet_params=vparams)
    check_visit(r5, "fifth visit, real/bogus network", card,
                keys=("S-P", "A-P", "PC-P", "TRANS-P", "MC-P"))
    h5 = r5.header
    trans = [q for q in r5.products if q.endswith("_red_trans.fits")][0]
    cols = next(d for d, _ in read_fits(trans) if isinstance(d, dict))
    found = check_night_transients(cols, tx, ty, card)
    prob = np.asarray(cols["CLASS_REAL"], np.float64)
    if not (np.isfinite(prob).all() and ((prob >= 0) & (prob <= 1)).all()):
        raise AssertionError("CLASS_REAL not finite in [0, 1]")
    x = np.asarray(cols["X_PEAK"], np.float64) - 1
    y = np.asarray(cols["Y_PEAK"], np.float64) - 1
    dd = np.hypot(x[:, None] - tx[None, :], y[:, None] - ty[None, :])
    real = dd.min(1) < 2.0
    (maps,) = seen
    cpu = vetnet.score_transients(
        vparams, *(a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in maps))
    err = float(np.abs(cpu.numpy() - np.asarray(cols["CLASS_REAL"])).max())
    if err > 1e-4:
        raise AssertionError(f"score_transients: card and CPU differ by "
                             f"{err}")
    t = {k: v * 1e3 for k, v in r5.timing.items()}
    t1 = {k: v * 1e3 for k, v in r1.timing.items()}
    t4 = {k: v * 1e3 for k, v in t4.items()}

    def dev_host(tt):
        dev = (tt.get(driver.SPAN_CALIB, 0.0)
               + tt.get(driver.SPAN_SUBTRACT, 0.0))
        return dev, tt["wall"] - dev
    d5, h5_ms = dev_host(t)
    d4, h4_ms = dev_host(t4)
    print(f"fifth visit: calibrate+extract {t1[driver.SPAN_CALIB]:.1f} ms "
          f"with the U-Net, {t[driver.SPAN_CALIB]:.1f} ms without it, "
          f"{t4[driver.SPAN_CALIB]:.1f} ms on the fourth visit [{card}]")
    print(f"fifth visit{' (without the U-Net)' if r5 is not r1 else ''}: "
          f"MC-P true, MC-MED "
          f"{h5['MC-MED']}, T-NTRANS {h5['T-NTRANS']}, {found} of {NTRANS} "
          f"transients; CLASS_REAL finite in [0, 1] on {len(prob)} rows, "
          f"median P(real) of the injected transients "
          f"{float(np.median(prob[real])) if real.any() else float('nan'):.4f}"
          f" ({int(real.sum())} rows), of the others "
          f"{float(np.median(prob[~real])) if (~real).any() else float('nan'):.4f}"
          f"; score_transients card vs CPU max |diff| {err:.2e}; wall "
          f"{t['wall']:.1f} ms, device {d5:.1f} ms, host {h5_ms:.1f} ms "
          f"(the fourth visit, no networks: wall {t4['wall']:.1f}, device "
          f"{d4:.1f}, host {h4_ms:.1f}) [{card}]")
    return maps, (tx, ty), sum(k1)


def chart_check(card, maps, trans):
    """Phase 9, last part: orient_data's Lanczos route on a cut-out
    around one transient of the fifth visit, card against CPU, without
    rendering."""
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.report.finding_chart import orient_data
    sci = maps[0]
    x, y = int(trans[0][0]), int(trans[1][0])
    n = 201
    cut = sci[y - n // 2:y + n // 2 + 1, x - n // 2:x + n // 2 + 1]
    cut = cut.cpu().numpy().astype(np.float32)
    wcs = TanWCS.simple(150.0, -30.0, 0.5642, (n, n), rot_deg=23.7)
    orient_data(cut, wcs, device="cuda")            # warm-up
    got, ms = synced(lambda: orient_data(cut, wcs, device="cuda"))
    want = orient_data(cut, wcs, device="cpu")
    err = float(np.abs(got - want).max())
    if err > 1e-5 * float(np.abs(cut).max()):
        raise AssertionError(f"orient_data: card and CPU differ by {err}")
    print(f"finding chart: orient_data (Lanczos3, 23.7 deg) of a {n}x{n} "
          f"cut-out around the transient at ({x}, {y}) on the card "
          f"{ms:.2f} ms, against the CPU max |diff| {err:.3g} e- "
          f"[{card}]")


def check_k1_unet(card, prob):
    """K1 at the U-Net's area filter shape: the binned mask's 64 steps,
    bit-exact against the plain version (outside the counted run)."""
    from blackbox_tpu_torch.ops import labeling
    lab = label_start(prob > 0.5)
    Hb, Wb = lab.shape
    err = max_abs_err(labeling.label_propagate(lab, 64),
                      labeling._label_propagate_plain(lab, 64))
    ms = cuda_ms(lambda: labeling.label_propagate(lab, 64))
    plain = cuda_ms(lambda: labeling._label_propagate_plain(lab, 64),
                    reps=1)
    nfg = int((lab < Hb * Wb + 2).sum())
    bnd = least_ms(8.0 * Hb * Wb, i32_ops=8.0 * 64 * nfg)
    print(f"K1 label_propagate U-Net mask {Hb}x{Wb} 64 steps "
          f"({nfg / (Hb * Wb):.6f} of pixels set): bit-exact, kernel "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd[0]:.3f} ms "
          f"({bnd[1]}) [{card}]")
    return dict(unet_ms=ms, unet_plain_ms=plain, unet_bound_ms=bnd[0],
                unet_shape=[Hb, Wb], unet_err=err)


# ---------------------------------------------------------------- phase 10

def same_tree(a, b, what):
    """Every tensor of two nested outputs bit for bit (NaN equal)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys {sorted(set(a) ^ set(b))}")
        for k in a:
            same_tree(a[k], b[k], f"{what} {k}")
    elif isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {a.shape} {a.dtype} against "
                                 f"{b.shape} {b.dtype}")
        try:
            max_abs_err(a, b)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None


def with_hits(img):
    """A copy of a 10560² frame with 400 cosmic hits of 4000 e- more
    (seed 4242), 20 of them on the columns of four shards' seams."""
    H, W = img.shape
    gen = torch.Generator(device="cuda").manual_seed(4242)
    ys = torch.randint(8, H - 8, (400,), generator=gen, device="cuda")
    xs = torch.randint(8, W - 8, (400,), generator=gen, device="cuda")
    xs[:20] = torch.tensor([W // 4 * (1 + i % 3) - i % 2 for i in range(20)],
                           device="cuda")
    data = img.clone()
    data.index_put_((ys, xs), torch.full((400,), 4000.0, device="cuda"),
                    accumulate=True)
    return data


def multi_device_phase(ctx, card, frame, tiny, mbias, mflat, xtalk):
    """Phase 10: the multi-device paths on one card (on every card, when
    there are more), each held to its single-device path.  The tile
    meshes hold four shards: cuda:0 four times on a one-card machine.

    - lacosmic_sharded on phase 3's last calibrated frame with 400
      cosmic hits more (20 on the shard seams) against the dense
      lacosmic, bit for bit;
    - extract_catalog_sharded on that frame against extract_catalog
      (bkg_boxsize 264: the production 256 does not tile a 2640-column
      shard, which the JAX package refuses too), every output bit for
      bit;
    - make_batched_reduce of two full MeerLICHT frames on a 2 x 1 mesh
      against make_reduce_fn per frame, bit for bit, K1 launched twice,
      K2 and K4 launched;
    - run_day(device_batch=2) of the TINY night on the card against
      phase 7's per-file TINY night on the card (night_parity), with no
      fallback;
    - dryrun_multichip(4) on the four tile devices."""
    import dataclasses as dc
    import shutil
    NP = night_parity()
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.ops.cosmics import lacosmic
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.orchestration.scheduler import run_day
    from blackbox_tpu_torch.parallel.dryrun import dryrun_multichip
    from blackbox_tpu_torch.parallel.extract import extract_catalog_sharded
    from blackbox_tpu_torch.parallel.mesh import (lacosmic_sharded,
                                                  make_batched_reduce,
                                                  make_mesh)
    from blackbox_tpu_torch.pipeline.driver import Pipeline
    from blackbox_tpu_torch.pipeline.reduce import (extract_catalog,
                                                    make_reduce_fn)
    from blackbox_tpu_torch.synth.device import make_science_device

    ncard = torch.cuda.device_count()
    devs = [torch.device("cuda", i % ncard) for i in range(4)]
    mesh = make_mesh(1, 4, devs)
    where = f"{len(devs)} tile shards on {', '.join(map(str, devs))}"

    # L.A.Cosmic: the frame with cosmic hits, 20 of them on the seams
    img, msk = frame[0].cuda(), frame[1].cuda()
    H, W = img.shape
    data = with_hits(img)
    p = dc.replace(ctx.lac_params, windowed=False)
    inmask = msk != 0
    with torch.inference_mode():
        (dclean, dcrm, _), dense_ms = synced(
            lambda: lacosmic(data, inmask, 10.0, p))
        (sclean, scrm), shard_ms = synced(
            lambda: lacosmic_sharded(data, inmask, 10.0, mesh, p))
    same_tree({"crmask": scrm, "clean": sclean},
              {"crmask": dcrm, "clean": dclean}, "lacosmic_sharded")
    print(f"lacosmic_sharded {H}x{W}, {where}: {int(scrm.sum())} cosmic "
          f"pixels, clean image and mask bit-exact against the dense "
          f"lacosmic; sharded {shard_ms:.1f} ms, dense {dense_ms:.1f} ms "
          f"[{card}]")
    del data, dclean, dcrm, sclean, scrm, inmask

    # extraction: every output of the sharded path bit for bit
    ctx_e = dc.replace(ctx, bkg_boxsize=264)
    with torch.inference_mode():
        dense, dense_ms = synced(lambda: extract_catalog(ctx_e, img, msk))
        shd, shard_ms = synced(
            lambda: extract_catalog_sharded(ctx_e, img, msk, mesh))
    dense.pop("psf"), shd.pop("psf")
    same_tree(shd, dense, "extract_catalog_sharded")
    print(f"extract_catalog_sharded {H}x{W}, {where}, box 264: nobjects "
          f"{int(shd['stats']['nobjects'])}, every plane, column and stat "
          f"bit-exact against extract_catalog; sharded {shard_ms:.1f} ms, "
          f"dense {dense_ms:.1f} ms [{card}]")
    del dense, shd, img, msk
    torch.cuda.empty_cache()

    # the batched reduce of two full frames on a 2 x 1 mesh
    geom = ctx.geom
    frames = []
    for seed in (12360, 12361):
        g = torch.Generator(device="cuda").manual_seed(seed)
        frames.append(make_science_device(g, geom, nstars=4000, ncosmics=800,
                                          trail=True, nsat=20)[:3])
    batch = tuple(torch.stack([f[k] for f in frames]) for k in range(3))
    bmesh = make_mesh(2, 1, devs[:2])
    before = launch_counts()
    outs, batch_ms = synced(lambda: make_batched_reduce(ctx, bmesh)(
        *batch, mbias, mflat, None, xtalk))
    moved = {k: n - before[k] for k, n in launch_counts().items()}
    if (moved["label_propagate"] != 2 or moved["median_filter"] <= 0
            or moved["gather_slot_windows"] <= 0):
        raise AssertionError(f"make_batched_reduce launches {moved}: K1 "
                             "must run twice, K2 and K4 must run")
    del batch
    fn = make_reduce_fn(ctx)
    single_ms = []
    for i, f in enumerate(frames):
        ref, ms = synced(lambda: fn(*f, mbias, mflat, None, xtalk))
        single_ms.append(ms)
        same_tree({k: outs[i][k] for k in ("image", "mask", "cat")},
                  {k: ref[k] for k in ("image", "mask", "cat")},
                  f"make_batched_reduce frame {i}")
        same_tree(outs[i]["stats"], {k: ref["stats"][k]
                                     for k in outs[i]["stats"]},
                  f"make_batched_reduce frame {i} stats")
        del ref
    print(f"make_batched_reduce of 2 MeerLICHT frames on a 2 x 1 mesh "
          f"({devs[0]}, {devs[1]}): every frame bit-exact against "
          f"make_reduce_fn, nobjects "
          f"{[int(o['stats']['nobjects']) for o in outs]}, launches "
          f"{moved}; {batch_ms:.1f} ms for the batch, "
          f"{sum(single_ms):.1f} ms one frame at a time [{card}]")
    del outs, frames
    torch.cuda.empty_cache()

    # the batched night against phase 7's per-file night on the card
    gpu, files, stars = tiny
    base = os.path.dirname(gpu[1])
    root = os.path.join(base, "batched")
    shutil.copytree(os.path.join(base, "raw"), root)
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                          create_ref=True, make_quicklooks=False)
    s.device_batch = 2
    pipe = Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                    ref_catalog=NP.ref_catalog(stars, TINY.red_shape),
                    device="cuda")
    rep, night_ms = synced(lambda: run_day(pipe, NP.DATE))
    by_path = {os.path.relpath(p, root): r for p, r in rep.results}
    rels = [os.path.relpath(f, os.path.join(base, "raw")) for f in files]
    if rep.batch_fallbacks or sorted(by_path) != sorted(rels):
        raise AssertionError(f"run_day(device_batch=2): {rep.batch_fallbacks}"
                             f" fallbacks, frames {sorted(by_path)}")
    batched = ([by_path[r] for r in rels], root)
    NP.check_night(batched, gpu, NP.overscan_level(gpu))
    print(f"run_day(device_batch=2) of the TINY night ({len(files)} frames) "
          f"on the card: batch_fallbacks 0, statuses, products, keywords "
          f"and flags, masks bit for bit, images, catalogs and transients "
          f"against the per-file night on the card; {night_ms:.1f} ms "
          f"[{card}]")

    _, dry_ms = synced(lambda: dryrun_multichip(4, devices=devs))
    print(f"dryrun_multichip(4) on {', '.join(map(str, devs))}: "
          f"{dry_ms:.1f} ms [{card}]")


# ---------------------------------------------------------------- phase 11

def lacosmic_phase(ctx, card, lac_input):
    """Phase 11: the windowed L.A.Cosmic rounds at full width, on the
    input phase 3's last frame gave ``lacosmic`` with 400 hits more
    (``with_hits``): the production parameters (windowed), the dense
    rounds (``windowed=False``), the pre-screen and ``max_cells`` below
    round 1's nact (every pass dense).  Each run's clean, mask and
    counts must equal the dense rounds' bit for bit, and the production
    run must take the windowed branch in a pass.  Each run's first call
    is the counted path; then the median of 3 more, host clock around
    synchronised calls.  Returns the K2 and K4 launches of that path
    (``counters``) and the production run's K4 calls (their arguments
    kept) for ``window_kernels``."""
    import dataclasses as dc
    from blackbox_tpu_torch.ops import cosmics
    data, inmask, rdn = lac_input
    data = with_hits(data.cuda())
    inmask, rdn = inmask.cuda(), rdn.cuda()
    H, W = data.shape
    base = ctx.lac_params
    configs = [("production (windowed)", base),
               ("dense rounds (windowed=False)",
                dc.replace(base, windowed=False)),
               ("prescreen=True", dc.replace(base, prescreen=True))]
    wanted = ("median_filter", "gather_slot_windows")
    runs, calls = {}, None
    i = 0
    while i < len(configs):
        label, params = configs[i]
        before = {n: kernels.launches[n] for n in wanted}
        with lacosmic_watch() as lac, k4_calls(i == 0) as k4:
            out = cosmics.lacosmic(data, inmask, rdn, params)
            torch.cuda.synchronize()
        moved = {n: kernels.launches[n] - before[n] for n in wanted}
        runs[label] = (out, lac["passes"], moved)
        if i == 0:
            calls = k4
            first = lac["passes"][0]
            if not any(q["branch"] == "windowed" for q in lac["passes"]):
                raise AssertionError(
                    f"phase 11: the production run took no windowed pass "
                    f"(round 1 nact {first['nact']} > max_cells "
                    f"{base.max_cells}): it proves nothing")
            configs.append((f"max_cells={first['nact'] - 1} (below round "
                            f"1's nact)", dc.replace(
                                base, max_cells=max(1, first["nact"] - 1))))
        i += 1
    counts = read_counts("windowed L.A.Cosmic (each run's first call)",
                         card, wanted)
    dense = runs["dense rounds (windowed=False)"][0]
    for label, params in configs:
        out, passes, moved = runs[label]
        same_tree({"clean": out[0], "crmask": out[1], "counts": out[2]},
                  {"clean": dense[0], "crmask": dense[1],
                   "counts": dense[2]}, f"phase 11 {label}")
        if label.startswith("max_cells") and any(
                q["branch"] != "dense" for q in passes):
            raise AssertionError(f"phase 11 {label}: {passes}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cosmics.lacosmic(data, inmask, rdn, params)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 11 L.A.Cosmic {H}x{W}, {label}: counts "
              f"{dense[2].tolist()}, {int(out[1].sum())} cosmic pixels, "
              f"clean, mask and counts bit-exact against the dense rounds; "
              f"{np.median(times):.1f} ms (median of "
              f"{', '.join(f'{t:.1f}' for t in times)}); K2 "
              f"{moved['median_filter']}, K4 {moved['gather_slot_windows']}"
              f" launches; {lac_rounds(passes)} [{card}]")
    k4 = [c for c in calls if c[1] == base.cell + 2 * cosmics._WIN_MARGIN]
    return counts, runs[configs[0][0]][2], k4


def window_kernels(card, calls):
    """K4 and K2 at the windowed rounds' shapes, on phase 11's
    production run, outside the counted path: every K4 call of that run
    (N windows of 112², three planes) bit for bit against its plain
    version and timed (``median_ms``, idle card and behind a sleep
    kernel), its bound from its live slots; the first call's plain and
    library (advanced indexing) times; then K2 on that call's windows
    stacked as ``_win_median`` stacks them (k = 3, 5, 7) against its
    plain version, with the k = 5 plane timed.  Returns the K4 and K2
    entries' ``window_*`` keys and the largest error."""
    from blackbox_tpu_torch.ops import cosmics, filters, windows
    err, shapes, idle, busy, bounds = 0.0, [], [], [], []
    for N, size, nimg, n_active, (imgs, y0, x0) in calls:
        live = N if n_active is None else int(n_active)
        got = windows.gather_slot_windows(imgs, y0, x0, size, n_active)
        ref = windows._gather_plain(imgs, y0, x0, size, n_active)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, ref)))
        idle.append(median_ms(lambda: windows.gather_slot_windows(
            imgs, y0, x0, size, n_active)))
        busy.append(median_ms(lambda: windows.gather_slot_windows(
            imgs, y0, x0, size, n_active), busy=True))
        # 4 B a window pixel of each plane: read for the live slots,
        # written for every slot
        bounds.append(least_ms(4.0 * nimg * size * size * (live + N))[0])
        shapes.append([N, size, nimg, live])
    N, size, nimg, n_active, (imgs, y0, x0) = calls[0]
    plain = median_ms(lambda: windows._gather_plain(imgs, y0, x0, size,
                                                    n_active))
    Hp, Wp = imgs[0].shape
    ar = torch.arange(size, device="cuda")
    iy = (y0[:, None, None] + ar[None, :, None]).clamp(0, Hp - 1)
    ix = (x0[:, None, None] + ar[None, None, :]).clamp(0, Wp - 1)
    lib = median_ms(lambda: tuple(im[iy, ix] for im in imgs))
    del iy, ix
    print(f"K4 gather_slot_windows at the windowed L.A.Cosmic's shape: "
          f"{len(calls)} calls a run ({', '.join(f'{s[0]}x{s[1]}^2 x {s[2]}'
                                                 f' ({s[3]} live)'
                                                 for s in shapes)}), "
          f"bit-exact; the first {idle[0]:.4f} ms from an idle card, "
          f"{busy[0]:.4f} ms behind a sleep kernel, plain {plain:.3f} ms, "
          f"library (plane[iy, ix] of the three planes) {lib:.3f} ms, "
          f"bound {bounds[0]:.4f} ms (bytes); all {len(calls)}: "
          f"{sum(idle):.4f} / {sum(busy):.4f} ms against a bound of "
          f"{sum(bounds):.4f} ms [{card}]")
    cw = windows.gather_slot_windows(imgs, y0, x0, size, n_active)[0]
    th, tw = filters.MEDIAN_TILE
    k2 = {}
    for k in filters.MEDIAN_KS:
        pk = k // 2
        T = size + 2 * pk
        plane = cosmics._edge_pad(cw, pk, pk, pk, pk).reshape(N * T, T)
        err = max(err, max_abs_err(filters.median_filter(plane, k),
                                   filters._median_plain(plane, k, 176)))
        if k == 5:
            ops, _, _ = filters.tile_median_ops(k, th, tw)
            per_px = filters.comparator_cost(ops) / (th * tw)
            k2 = {"window_plane": [N * T, T],
                  "window_plane_ms": cuda_ms(
                      lambda: filters.median_filter(plane, 5)),
                  "window_plane_plain_ms": cuda_ms(
                      lambda: filters._median_plain(plane, 5, 176), reps=1),
                  "window_plane_bound_ms": least_ms(
                      8.0 * plane.numel(), f32_ops=per_px * plane.numel())[0]}
    print(f"K2 median_filter on {N} windows of {size}^2 stacked "
          f"(k = 3, 5, 7, each window edge-padded by k//2): bit-exact; "
          f"k = 5 plane {k2['window_plane'][0]}x{k2['window_plane'][1]} "
          f"{k2['window_plane_ms']:.3f} ms, plain "
          f"{k2['window_plane_plain_ms']:.3f} ms, bound "
          f"{k2['window_plane_bound_ms']:.4f} ms [{card}]")
    k4 = {"window112_calls": shapes, "window112_ms": idle[0],
          "window112_busy_ms": busy[0], "window112_plain_ms": plain,
          "window112_library_ms": lib, "window112_bound_ms": bounds[0],
          "window112_run_ms": [sum(idle), sum(busy)],
          "window112_run_bound_ms": sum(bounds)}
    return k4, k2, err


# --------------------------------------------------------------- phase 12

KNOB_DARK_RATE = 2.0    # e-/s, the full-width darks' dark current
KNOB_NONLIN = 0.02      # the spline file's correction below ~1e3 ADU
KNOB_BPM_SCATTER = 300  # scattered BAD pixels of the full-width static mask
KNOB_VISIT = "ML1_20260301_235000.fits"
KNOB_SPLINES = "nonlin_splines.pkl"


def knob_tiny_phase(card, base):
    """Phase 12, first part: the TINY knob night of
    tests/test_torch_wiring.py (``night_parity.tiny_knob_night``: the
    TINY night with three darks, a static bad-pixel mask and a 2 %
    non-linearity correction named relative to ``cal_dir``,
    ``create_mdark``, ``create_ref`` and the field grid) through the
    port's Pipeline on the card and on the CPU, each in its own copy of
    the raw tree, held together by ``night_parity.check_night`` (a
    transient's pixel count within its ``threshold_band``); then
    the granular resume of its second visit, twice, on each device in a
    copy of the CPU's reduced tree: the knobs' flags on each device
    (``check_knobs``), the resumes' keywords and rewritten catalogs card
    against CPU, and each rewritten catalog the extraction of the
    published image on its device bit for bit
    (``check_resumed_catalog``)."""
    import shutil
    NP = night_parity()
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline

    raw = os.path.join(base, "raw")
    files, stars = NP.tiny_knob_night(raw)
    files = [os.path.relpath(f, raw) for f in files]
    query = NP.ref_catalog(stars, TINY.red_shape)

    def pipeline(root, device):
        s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                              create_ref=True, make_quicklooks=False,
                              **NP.knob_settings(root))
        return Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                        ref_catalog=query, field_grid=NP.FIELD_GRID,
                        device=device)

    devices = ("cuda", "cpu")
    runs, resumes = {}, {}
    for i, device in enumerate(devices):
        root = os.path.join(base, f"night{i}")
        shutil.copytree(raw, root)
        pipe = pipeline(root, device)
        runs[i] = ([pipe.process_file(os.path.join(root, f))
                    for f in files], root)
    statuses = [r.status for r in runs[0][0]]
    if statuses != ["reduced"] * len(files):
        raise AssertionError(f"TINY knob night on {devices[0]}: {statuses} "
                             f"{[r.error for r in runs[0][0] if r.error]}")
    level = NP.overscan_level(runs[1])
    NP.check_night(runs[0], runs[1], level, npix_band=True)
    rpipes = {}
    for i, device in enumerate(devices):
        root = os.path.join(base, f"resume{i}")
        shutil.copytree(runs[1][1], root)
        rpipes[i] = pipeline(root, device)
        resumes[i] = NP.resume(rpipes[i], os.path.join(root, files[-1]))
    mdmean = [NP.check_knobs(runs[i], resumes[i], TINY.red_shape)
              for i in range(2)]
    for k in range(2):
        NP.check_headers(([resumes[0][k]], None), ([resumes[1][k]], None),
                         level)
    cats = [next(p for p in resumes[i][-1].products
                 if p.endswith("_red_cat.fits")) for i in range(2)]
    NP.check_catalog_pair(*cats)
    with uncounted():
        for i in range(2):
            NP.check_resumed_catalog(rpipes[i], cats[i])
    h = runs[0][0][-1].header
    print(f"TINY knob night ({len(files)} frames, {devices[0]} vs "
          f"{devices[1]}): statuses, products, keywords and flags equal, "
          f"masks bit for bit, images, catalogs and transients within the "
          f"parity tolerances; BPM-F, NONLIN-P, RADECOFF, MDMEAN "
          f"{mdmean[0]} / {mdmean[1]} e-/s (injected {NP.DARK_RATE} / 1.02), "
          f"T-NTRANS {h['T-NTRANS']}; two resumes RED-REUSED, catalogs "
          f"within the parity tolerances and each the extraction of the "
          f"published image bit for bit [{card}]")


def nonlin_pickle(path, nchan):
    """A reference-format non-linearity file: a pickled list of one scipy
    UnivariateSpline a channel, the fractional correction over 0-50k ADU:
    KNOB_NONLIN plus a quadratic rise of 0.3-0.5 % at 50k ADU, which adds
    under 2e-6 below 1e3 ADU (the sky and the darks are ~50-120 ADU)."""
    import pickle
    from scipy.interpolate import UnivariateSpline
    adu = np.linspace(0.0, 5e4, 200)
    splines = [UnivariateSpline(adu, KNOB_NONLIN + (0.003 + 0.002 * c / nchan)
                                * (adu / 5e4) ** 2, k=3, s=0)
               for c in range(nchan)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(splines, f)


def timing_line(label, r, card):
    """One process_file call's wall, device and host ms."""
    from blackbox_tpu_torch.pipeline import driver
    ms = {k: v * 1e3 for k, v in r.timing.items()}
    dev_ms = ms.get(driver.SPAN_CALIB, 0.0) + ms.get(driver.SPAN_SUBTRACT,
                                                      0.0)
    print(f"{label}: wall {ms['wall']:.1f} ms, device {dev_ms:.1f} ms "
          f"(calibrate+extract {ms.get(driver.SPAN_CALIB, 0.0):.1f}, "
          f"run_subtraction {ms.get(driver.SPAN_SUBTRACT, 0.0):.1f}), host "
          f"{ms['wall'] - dev_ms:.1f} ms (masters "
          f"{ms.get(driver.SPAN_MASTERS, 0.0):.1f}, Rice writes "
          f"{ms.get(driver.SPAN_RICE, 0.0):.1f}) [{card}]")


@contextlib.contextmanager
def uncounted():
    """Launches made inside are a check's, not the path's: the counts
    are put back as they were."""
    before = kernels.launches.copy()
    try:
        yield
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)


def resumed_catalog(pipe, cat_p, first, label, card):
    """The resumed catalog ``cat_p``: its EXTRACTED columns bit for bit
    those of ``extract_catalog`` run again on the card on the published
    image and mask as ``Pipeline`` decodes them
    (``night_parity.check_resumed_catalog``, uncounted), and its columns
    and dtypes those of the first catalog ``first``.  The first was
    extracted from the frame in memory, the resume from its Rice-coded
    copy (q = 16: within half a step, the mask equal), so their rows are
    only printed beside each other: those paired within 0.25 px and the
    paired optimal fluxes' differences in errors."""
    from scipy.spatial import cKDTree
    NP = night_parity()
    with uncounted():
        n = NP.check_resumed_catalog(pipe, cat_p)
    got = NP.table(cat_p)
    if [(k, np.asarray(v).dtype) for k, v in got.items()] != \
            [(k, np.asarray(v).dtype) for k, v in first.items()]:
        raise AssertionError(f"{label}: columns differ from the first's")
    g, w = (np.stack([np.asarray(c[k], np.float64)
                      for k in ("X_POS", "Y_POS")], 1) for c in (got, first))
    dist, match = cKDTree(w).query(g, distance_upper_bound=0.25)
    paired = np.isfinite(dist)
    f = np.asarray(got["E_FLUX_OPT"], np.float64)[paired]
    fw = np.asarray(first["E_FLUX_OPT"], np.float64)[match[paired]]
    e = np.asarray(first["E_FLUXERR_OPT"], np.float64)[match[paired]]
    dflux = np.abs(f - fw) / e
    print(f"{label}: {n} rows, the extraction of the published image bit "
          f"for bit in {len(NP.EXTRACTED)} columns; against the first "
          f"catalog's {len(w)} rows: {int(paired.sum())} paired within "
          f"{dist[paired].max():.4f} px, optimal fluxes "
          f"{np.median(dflux):.3f} errors apart at the median, "
          f"{dflux.max():.3f} at most, {int((dflux > 1.0).sum())} over one "
          f"[{card}]")


def driver_knobs_phase(card, night):
    """Phase 12, second part, in phase 7's tree at full MeerLICHT width,
    through a Pipeline with the night's settings and context plus the
    knobs: ``bad_pixel_mask`` (the middle half of one column and
    KNOB_BPM_SCATTER scattered pixels, ``night_parity.bpm_pixels``) and
    ``nonlin_corr_file`` (a reference-format spline pickle written here,
    ``nonlin_pickle``), both named relative to ``cal_dir``,
    ``correct_nonlin``, ``create_mdark`` and ``field_grid`` {42: the
    field centre}.  Three 60-s darks made on the card (the night's bias
    structure plus KNOB_DARK_RATE e-/s, Poisson) make the master dark:
    NDARK 3, MDMEAN within 1 % of KNOB_DARK_RATE / (1 + KNOB_NONLIN)
    (the darks are corrected too; the mean of 1.1e8 pixels is good to
    1e-5 e-/s, and the master bias, a stack of overscan-corrected
    biases, leaves ~1e-4); the stack's device span is printed.  Then
    phase 7's first visit's raw frame again, as KNOB_VISIT: BPM-F and
    the BAD bit at every pixel of the static mask, NONLIN-P, S-BKG at
    the first visit's S-BKG / (1 + KNOB_NONLIN) within 1e-3 of itself
    (the same raw pixels and masters: the correction divides the sky by
    1.02; the mask takes 0.005 % of the pixels out of the background
    statistics), RADECOFF under 5 arcmin, and the subtraction against
    the field's reference (K6 launched).  Then the resume: its catalog
    deleted, the visit again with ``trans_extract=False``: RED-REUSED,
    no master looked up and no calibration program called, and the
    catalog the extraction of the published image (``resumed_catalog``)."""
    import shutil
    NP = night_parity()
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.pipeline import driver, masters
    from blackbox_tpu_torch.synth.device import make_science_device
    from blackbox_tpu_torch.utils.timing import timer

    pipe0 = night["pipe"]
    geom, dev = pipe0.geom, pipe0.device
    root = night["root"]
    cal = os.path.join(root, NP.CAL_DIR)
    t0 = time.time()
    NP.write_bpm(os.path.join(cal, NP.BPM_FILE), geom.red_shape,
                 KNOB_BPM_SCATTER)
    nonlin_pickle(os.path.join(cal, KNOB_SPLINES), geom.n_chan)
    settings = dataclasses.replace(night["settings"], **dict(
        NP.knob_settings(root), nonlin_corr_file=KNOB_SPLINES))
    ctx = dataclasses.replace(pipe0.ctx, correct_nonlin=True)
    ra0, dec0 = 150.0, -30.0
    pipe = driver.Pipeline(night["tree"], "ML1", settings, ctx,
                           ref_catalog=night["query"],
                           field_grid={42: (ra0, dec0)}, device=dev)
    if pipe.nonlin_coeffs is None:
        raise AssertionError(f"the driver did not convert {KNOB_SPLINES}")
    print(f"static mask ({KNOB_BPM_SCATTER} pixels and half a column) and "
          f"spline file written, converted to {pipe.nonlin_coeffs.shape} "
          f"coefficients, in {time.time() - t0:.1f} s [{card}]")

    # the darks and their master
    spans = {}
    build = masters.master_dark

    def timed(*args):
        with timer("master dark stack", sync=dev, spans=spans):
            return build(*args)
    gains = torch.tensor(ctx.gains, device=dev)[:, None, None]
    e = KNOB_DARK_RATE * 60.0
    masters.master_dark = timed
    try:
        for k in range(3):
            gen = torch.Generator(device=dev).manual_seed(1200 + k)
            chan, osv, osh = make_science_device(
                gen, geom, nstars=0, sky_e=0.0, ncosmics=0, trail=False,
                nsat=0)[:3]
            chan = chan + (e + math.sqrt(e) * torch.randn(
                chan.shape, generator=gen, device=dev)) / gains
            path = night["write"]((chan, osv, osh), "dark", 20 + k, 60.0,
                                  ra0, dec0)
            del chan, osv, osh
            r = pipe.process_file(path)
            if r.status != "reduced" or r.header.get("NONLIN-P") is not True:
                raise AssertionError(f"dark {k}: {r.status} {r.error}")
            timing_line(f"phase 12 dark {k}", r, card)
    finally:
        masters.master_dark = build
    mdark, mh = pipe.masters.ensure_master("dark", NIGHT_DATE, geom)
    want = KNOB_DARK_RATE / (1.0 + KNOB_NONLIN)
    if mdark is None or int(mh["NDARK"]) != 3 or \
            abs(float(mh["MDMEAN"]) - want) > 0.01 * want:
        raise AssertionError(f"master dark: NDARK {mh and mh['NDARK']}, "
                             f"MDMEAN {mh and mh['MDMEAN']} (want {want:.4f})")
    if "master dark stack" not in spans:
        raise AssertionError("the master dark was not stacked")
    print(f"master dark: NDARK {mh['NDARK']}, MDMEAN {mh['MDMEAN']} e-/s "
          f"(injected {KNOB_DARK_RATE} / {1 + KNOB_NONLIN} = {want:.4f}), "
          f"MDRDN {mh.get('MDRDN')} e-/s; the device stack of the three darks "
          f"(master_dark, synchronised) "
          f"{spans['master dark stack'] * 1e3:.1f} ms [{card}]")

    # the knobbed visit
    src = night["files"][6]
    path = os.path.join(os.path.dirname(src), KNOB_VISIT)
    shutil.copy(src, path)
    k6 = kernels.launches["fft_cols_split"]
    r = pipe.process_file(path)
    check_visit(r, "phase 12 visit", card,
                keys=("S-P", "A-P", "PC-P", "NONLIN-P", "TRANS-P"))
    timing_line("phase 12 visit", r, card)
    h, h0 = r.header, night["res"][6].header
    if h.get("BPM-F") != NP.BPM_FILE:
        raise AssertionError(f"BPM-F {h.get('BPM-F')}")
    mask_p = next(p for p in r.products if p.endswith("_mask.fits.fz"))
    m = read_rice(mask_p)[0].astype(np.uint8)
    bpm = NP.bpm_pixels(geom.red_shape, KNOB_BPM_SCATTER)
    if not np.all(m[bpm] & maskbits.BAD):
        raise AssertionError("a pixel of the static mask is not BAD")
    b1, b0 = float(h["S-BKG"]), float(h0["S-BKG"])
    bwant = b0 / (1.0 + KNOB_NONLIN)
    if abs(b1 - bwant) > 1e-3 * bwant:
        raise AssertionError(f"S-BKG {b1}, want {b0} / {1 + KNOB_NONLIN} "
                             f"= {bwant:.4f}")
    if not float(h["RADECOFF"]) < 5.0:
        raise AssertionError(f"RADECOFF {h['RADECOFF']}")
    if kernels.launches["fft_cols_split"] == k6:
        raise AssertionError("the visit's subtraction launched no K6")
    print(f"phase 12 visit: BPM-F {h['BPM-F']} ({len(bpm[0])} pixels BAD in "
          f"the published mask), NONLIN-P, S-BKG {b1} against the first "
          f"visit's {b0} / {1 + KNOB_NONLIN} = {bwant:.4f} "
          f"({(b1 - bwant) / bwant:+.2e}), RADECOFF {h['RADECOFF']} arcmin, "
          f"T-NTRANS {h['T-NTRANS']}, TQC-FLAG {h.get('TQC-FLAG')} [{card}]")

    # the granular resume
    cat_p = next(p for p in r.products if p.endswith("_red_cat.fits"))
    first = NP.table(cat_p)
    os.remove(cat_p)
    calls = []
    names = ("_reduce_sci", "_calibrate", "_calibrate_cal")
    real = {n: getattr(pipe, n) for n in names}
    for n in names:
        setattr(pipe, n, lambda *a, _n=n: calls.append(_n) or real[_n](*a))
    try:
        r2 = pipe.process_file(path, trans_extract=False)
    finally:
        for n in names:
            setattr(pipe, n, real[n])
    if r2.status != "reduced" or r2.header.get("RED-REUSED") is not True:
        raise AssertionError(f"resume: {r2.status} {r2.error} RED-REUSED "
                             f"{r2.header and r2.header.get('RED-REUSED')}")
    if calls or driver.SPAN_MASTERS in r2.timing:
        raise AssertionError(f"resume calibrated again: {calls} "
                             f"{sorted(r2.timing)}")
    timing_line("phase 12 resume (RED-REUSED, no calibration)", r2, card)
    print(f"phase 12 resume: S-SEEING {r2.header.get('S-SEEING')} arcsec "
          f"against the first call's {h.get('S-SEEING')}, NOBJECTS "
          f"{r2.header.get('NOBJECTS')} against {h.get('NOBJECTS')} "
          f"[{card}]")
    resumed_catalog(pipe, cat_p, first, "phase 12 resumed catalog", card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    # phase 1: device and build
    card = card_label()
    print(card)
    t0 = time.time()
    kernels.build()
    print(f"built the CUDA kernels in {time.time() - t0:.1f} s")

    from blackbox_tpu_torch.core.geometry import MEERLICHT
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext

    ctx = ReduceContext.from_defaults(
        MEERLICHT, "ML1", lac_params=LACosmicParams(strip_rows=176),
        det_params=DetectParams(max_sources=20000, label_iters=32))

    # phase 2: kernels against their plain versions
    results = check_kernels(card)
    torch.cuda.empty_cache()

    C, ych, xch = MEERLICHT.chan_shape
    mgen = torch.Generator(device="cuda").manual_seed(99)
    mbias = 0.5 * torch.randn((C, ych, xch), generator=mgen, device="cuda")
    mflat = 1.0 + 0.02 * torch.randn((C, ych, xch), generator=mgen,
                                     device="cuda")
    xtalk = np.random.default_rng(0).uniform(-2e-4, 2e-4, (C, C)).astype(
        np.float32)

    # phase 3: raw -> catalog
    kernels.launches.clear()
    frame, lac_input = reduce_phase(ctx, card, mbias, mflat, xtalk)
    c3 = read_counts("raw -> catalog", card, ("label_propagate",
                                              "median_filter",
                                              "gather_slot_windows",
                                              "fill_holes"))
    if c3["label_propagate"] != len(SEEDS):
        raise AssertionError(f"label_propagate: {c3['label_propagate']} "
                             f"launches for {len(SEEDS)} catalog frames")
    # the saturation mask's and the cosmic mask's hole fills
    if c3["fill_holes"] != 2 * len(SEEDS):
        raise AssertionError(f"fill_holes: {c3['fill_holes']} launches "
                             f"for {len(SEEDS)} frames")
    torch.cuda.empty_cache()

    # phase 4: raw -> transient catalog
    kernels.launches.clear()
    nframes = science_phase(ctx, card, mbias, mflat, xtalk)
    c4 = read_counts("raw -> transient catalog", card,
                     ("label_propagate", "median_filter",
                      "gather_slot_windows", "fft_cols_split",
                      "fused_detect", "fill_holes", "warp_pass"))
    # one K1 launch for the reference's catalog, then two a science
    # frame (the catalog's 32 steps, the transients' 48 in one launch),
    # none in the frame where BBTPU_PALLAS_DETECT=1 routes both to K5
    if c4["label_propagate"] != 1 + 2 * (nframes - 1):
        raise AssertionError(f"label_propagate: {c4['label_propagate']} "
                             f"launches for {nframes} science frames")
    if c4["fft_cols_split"] != 6 * nframes:
        raise AssertionError(f"fft_cols_split: {c4['fft_cols_split']} "
                             f"launches for {nframes} science frames")
    # the remap's two passes a science frame
    if c4["warp_pass"] != 2 * nframes:
        raise AssertionError(f"warp_pass: {c4['warp_pass']} launches for "
                             f"{nframes} science frames")

    torch.cuda.empty_cache()

    # phase 5: calibration night, then raw -> catalog through K7, and K3
    kernels.launches.clear()
    nk7, first = calib_phase(ctx, card, xtalk)
    c5 = read_counts("calibration night + K7 reduction + K3 planes", card,
                     ("label_propagate", "gather_slot_windows",
                      "lacosmic_fused", "upsample_mesh", "fill_holes"))
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
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        tiny = tiny_night_phase(card, os.path.join(root, "tiny"))
        with k4_calls(False) as night_k4:
            c7, night = night_phase(ctx, card, root)
        k4_live(night_k4, "phase 7's night", card)
        del night_k4
        c8, t4 = coadd_phase(card, night)
        torch.cuda.empty_cache()

        # phase 9: the networks and segment mode at full width, then a
        # fifth visit through the driver with both networks
        t9 = time.time()
        kernels.launches.clear()
        unet, prob = unet_phase(card, *frame)
        segment_phase(card, ctx, *frame)
        torch.cuda.empty_cache()
        maps, trans, k1_visit = vetnet_phase(card, night, unet, t4, root)
        torch.cuda.synchronize()
        c9 = read_counts("networks and segment mode", card,
                         ("label_propagate", "median_filter",
                          "gather_slot_windows", "fft_cols_split",
                          "fill_holes"))
        if (c9["label_propagate"] != 2 + k1_visit
                or c9["fft_cols_split"] != 6):
            raise AssertionError(
                f"phase 9: label_propagate {c9['label_propagate']} (two "
                f"U-Net passes and the fifth visit's {k1_visit}), "
                f"fft_cols_split {c9['fft_cols_split']} (one subtraction: "
                f"6)")
        chart_check(card, maps, trans)
        del maps
        k1_unet = check_k1_unet(card, prob)
        del prob
        print(f"phase 9: {time.time() - t9:.1f} s [{card}]")

        # phase 10: the multi-device paths on one card, their launches
        # counted
        torch.cuda.empty_cache()
        t10 = time.time()
        kernels.launches.clear()
        multi_device_phase(ctx, card, frame, tiny, mbias, mflat, xtalk)
        del frame, tiny
        c10 = read_counts("multi-device on one card", card,
                          ("label_propagate", "median_filter",
                           "gather_slot_windows", "fft_cols_split",
                           "fill_holes"))
        print(f"phase 10: {time.time() - t10:.1f} s [{card}]")

        # phase 11: the windowed L.A.Cosmic rounds at full width against
        # the dense ones, their launches counted; then K4 and K2 at their
        # shapes
        torch.cuda.empty_cache()
        t11 = time.time()
        kernels.launches.clear()
        c11, lac_moved, lac_k4 = lacosmic_phase(ctx, card, lac_input)
        del lac_input
        k4_window, k2_window, werr = window_kernels(card, lac_k4)
        del lac_k4
        print(f"phase 11: {time.time() - t11:.1f} s [{card}]")

        # phase 12: the driver's optional calibration branches, TINY on
        # the card against the CPU, then at full width in phase 7's tree,
        # their launches counted
        torch.cuda.empty_cache()
        t12 = time.time()
        kernels.launches.clear()
        knob_tiny_phase(card, os.path.join(root, "knobs"))
        driver_knobs_phase(card, night)
        del night
        torch.cuda.synchronize()
        c12 = read_counts("driver knobs", card,
                          ("label_propagate", "median_filter",
                           "gather_slot_windows", "fft_cols_split",
                           "fill_holes"))
        print(f"phase 12: {time.time() - t12:.1f} s [{card}]")

    for r in results:
        r["launches"] = (c3[r["name"]] + c4[r["name"]] + c5[r["name"]]
                         + c7[r["name"]] + c8[r["name"]] + c9[r["name"]]
                         + c10[r["name"]] + c11[r["name"]]
                         + c12[r["name"]])
        r["lacosmic_phase_launches"] = c11[r["name"]]
        r["driver_knobs_phase_launches"] = c12[r["name"]]
        if r["name"] in lac_moved:
            r["lacosmic_windowed_launches"] = lac_moved[r["name"]]
        if r["name"] == "gather_slot_windows":
            r.update(k4_window)
            r["max_abs_err"] = max(r["max_abs_err"], werr)
        if r["name"] == "median_filter":
            r.update(k2_window)
            r["max_abs_err"] = max(r["max_abs_err"], werr)
        r["file_to_file_launches"] = c7[r["name"]]
        r["coadd_phase_launches"] = c8[r["name"]]
        r["networks_phase_launches"] = c9[r["name"]]
        r["multi_device_phase_launches"] = c10[r["name"]]
        if r["name"] == "label_propagate":
            r.update(k1_unet)
            r["max_abs_err"] = max(r["max_abs_err"], r.pop("unet_err"))
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all [{card}]")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
