"""The port's trail detector in segment mode (ops/satdet.py
``detect_trails(want_lines=True)`` and ``detect_trail_segments``)
against the JAX package's, on the CPU: masks and counts exact, the
line parameters to float32 rounding.

The frames are tests/test_detection.py's (1024², bin 2): a ~30% streak
the full frame misses and the segments find once, a full trail seeded
through ``exclude_lines`` that gives no new segment, and noise.  Three
faults of the reference live in this code, and the port matches them:
``ops/satdet.py:535`` seeds every ``exclude_lines`` slot, inactive ones
too; ``:454`` wraps the line offset modulo the transform size, so a
trail near the frame's right edge can be counted twice; and a bright
diagonal trail leaves ghost lines in the segment tiles that count as
new trails.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import night_parity as NP  # noqa: E402
import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import (assert_close, assert_exact, jax_ctx, t,  # noqa: E402
                          tiny_frame)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackbox_tpu.ops import satdet as J  # noqa: E402
from blackbox_tpu_torch.ops import satdet as T  # noqa: E402

H = W = 1024
P = dict(bin_factor=2)


def _params(mod):
    return mod.SatDetParams(**P)


def _streak(seed=0):
    """~30% of a line lit at 8 sigma/px (tests/test_detection.py)."""
    img = np.random.default_rng(seed).normal(0, 1, (H, W)).astype(np.float32)
    for x in range(80, 80 + 310):
        img[int(120 + 0.3 * (x - 80)), x] += 8.0
    return img


def _full_trail(seed=1):
    img = np.random.default_rng(seed).normal(0, 1, (H, W)).astype(np.float32)
    for x in range(W):
        y = int(100 + 0.7 * x)
        if 0 <= y < H:
            img[y, x] += 10.0
    return img


_JFULL = jax.jit(lambda a: J.detect_trails(a, None, _params(J),
                                            want_lines=True))
_JSEG = jax.jit(lambda a, ex: J.detect_trail_segments(
    a, None, _params(J), exclude_lines=ex))


def _jax_full(img):
    return _JFULL(jnp.asarray(img))


def _jax_segments(img, exclude=None):
    return _JSEG(jnp.asarray(img), exclude)


def _port_full(img):
    return T.detect_trails(torch.from_numpy(img), None, _params(T),
                           want_lines=True)


def _port_segments(img, exclude=None):
    return T.detect_trail_segments(torch.from_numpy(img), None, _params(T),
                                   exclude_lines=exclude)


def _check_lines(got, want):
    """Line parameters: slots in the same order, float32 rounding."""
    assert_close(got["theta"], want["theta"], rtol=1e-6, atol=1e-7)
    assert_close(got["t"], want["t"], rtol=1e-5, atol=1e-3)
    assert_close(got["snr"], want["snr"], rtol=1e-4)


@pytest.mark.parametrize("frame", ["full_trail", "streak"])
def test_want_lines_matches_jax(frame):
    """The full-frame pass with its lines.  Its mask is exact but for
    pixels at the rasterisation threshold on the mask's edge, which an
    ulp of cos θ moves (night_parity.mask_edge_flips: XLA's and
    PyTorch's float32 cos differ at some grid angles)."""
    img = _full_trail() if frame == "full_trail" else _streak()
    wm, wn, ws, wl = _jax_full(img)
    gm, gn, gs, gl = _port_full(img)
    assert NP.mask_edge_flips(gm.numpy(), wm) <= 1e-3 * max(
        int(np.sum(wm)), 1)
    assert int(gn) == int(wn) == (1 if frame == "full_trail" else 0)
    assert_close(gs, ws, rtol=1e-4)
    _check_lines(gl, wl)
    # the lines are the snr slots: inactive slots carry snr 0
    assert_exact(gl["snr"] > 0, np.asarray(wl["snr"]) > 0)


def test_partial_streak_found_once():
    img = _streak()
    wm, wn, ws = _jax_segments(img)
    gm, gn, gs = _port_segments(img)
    assert int(wn) == int(gn) == 1
    assert_exact(gm, wm)
    assert int(gm.sum()) > 0
    assert_close(gs, ws, rtol=1e-4)


def test_full_trail_seeded_gives_no_new_segment():
    img = _full_trail()
    _, wnf, _, wl = _jax_full(img)
    _, gnf, _, gl = _port_full(img)
    assert int(wnf) == int(gnf) == 1
    wm, wn, _ = _jax_segments(img, wl)
    gm, gn, _ = _port_segments(img, gl)
    assert int(wn) == int(gn) == 0
    assert_exact(gm, wm)


def test_noise_gives_nothing():
    img = np.random.default_rng(2).normal(0, 1, (H, W)).astype(np.float32)
    wm, wn, _ = _jax_segments(img)
    gm, gn, _ = _port_segments(img)
    assert int(wn) == int(gn) == 0
    assert_exact(gm, wm)
    assert not gm.any()


def test_inactive_exclude_slots_suppress_fault():
    """ops/satdet.py:535: every exclude_lines slot seeds the NMS, the
    inactive ones too.  An empty full-frame pass leaves its slots at
    θ = 0 and offsets 0..7 (binned): a near-vertical streak 20 px from
    the left edge is found without exclude_lines and suppressed with
    them, in both packages."""
    img = np.random.default_rng(3).normal(0, 1, (H, W)).astype(np.float32)
    img[200:520, 20] += 8.0
    _, wnf, _, wl = _jax_full(img)
    _, gnf, _, gl = _port_full(img)
    assert int(wnf) == int(gnf) == 0
    _check_lines(gl, wl)
    for ex_j, ex_t, want in ((None, None, 1), (wl, gl, 0)):
        wm, wn, _ = _jax_segments(img, ex_j)
        gm, gn, _ = _port_segments(img, ex_t)
        assert int(wn) == int(gn) == want
        assert_exact(gm, wm)


def test_offset_wrap_double_count_fault():
    """ops/satdet.py:454: t_phys wraps modulo N, the full frame's N and
    each tile's, so a near-vertical trail near the right edge (its
    offset past -N/2 in both) gets global offsets that do not match:
    the full frame counts it and the seeded segment pass counts it
    again.  The mask is unaffected; both packages count 2."""
    img = np.random.default_rng(4).normal(0, 1, (H, W)).astype(np.float32)
    for y in range(H):
        img[y, int(900 + 0.05 * y)] += 10.0
    _, wnf, _, wl = _jax_full(img)
    _, gnf, _, gl = _port_full(img)
    assert int(wnf) == int(gnf) == 1
    _check_lines(gl, wl)
    wm, wn, _ = _jax_segments(img, wl)
    gm, gn, _ = _port_segments(img, gl)
    assert int(wn) == int(gn) == 1
    assert_exact(gm, wm)


def test_diagonal_trail_ghost_count_fault():
    """A fault of the reference, matched: a bright full trail along the
    synthetic frame's diagonal (synth/device.py's, from (0.1 W, 0.2 H)
    to (0.9 W, 0.8 H)), at the production binned geometry (2640² at bin
    4 bins to 660², as 10560² at bin 16 does), is counted once by the
    full frame, and twice more by the seeded segment pass: two tiles
    report a parallel ghost line about a tile stride off the
    trail, whose global offset matches no seed.  Both packages count
    1 + 2 for one trail; the masks agree but for edge pixels."""
    H = W = 2640
    img = np.random.default_rng(0).normal(0, 1, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x0, y0, x1, y1 = 0.1 * W, 0.2 * H, 0.9 * W, 0.8 * H
    nx, ny = y1 - y0, -(x1 - x0)
    d = np.abs((xx - x0) * nx + (yy - y0) * ny) / np.hypot(nx, ny)
    img += (10.0 * np.exp(-0.5 * (d / 0.8) ** 2)).astype(np.float32)
    pj, pt = J.SatDetParams(bin_factor=4), T.SatDetParams(bin_factor=4)
    _, wnf, _, wl = jax.jit(lambda a: J.detect_trails(
        a, None, pj, want_lines=True))(jnp.asarray(img))
    wm, wn, _ = jax.jit(lambda a, ex: J.detect_trail_segments(
        a, None, pj, exclude_lines=ex))(jnp.asarray(img), wl)
    _, gnf, _, gl = T.detect_trails(torch.from_numpy(img), None, pt,
                                    want_lines=True)
    gm, gn, _ = T.detect_trail_segments(torch.from_numpy(img), None, pt,
                                        exclude_lines=gl)
    assert int(wnf) == int(gnf) == 1
    assert int(wn) == int(gn) == 2
    _check_lines(gl, wl)
    NP.mask_edge_flips(gm.numpy(), wm)


def test_calibrate_detector_with_segments_matches_jax():
    """calibrate_detector with detect_sat_segments=True on a TINY frame:
    the full-frame pass with its lines, then the seeded segment pass,
    masks ORed and counts added, as the JAX package does."""
    from blackbox_tpu.pipeline.reduce import calibrate_detector as jcal
    from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,
                                                    calibrate_detector)
    ctx = jax_ctx(detect_sat_segments=True)
    ctx = dataclasses.replace(ctx, lac_params=dataclasses.replace(
        ctx.lac_params, niter=1, windowed=False))
    tctx = ReduceContext.from_reference(ctx)
    assert tctx.detect_sat_segments
    chan, osv, osh, _, mflat, _, _ = tiny_frame(7)
    want_img, want_mask, want_st = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda *a: jcal(ctx, *a))(
            *(jnp.asarray(a) for a in (chan, osv, osh)), None,
            jnp.asarray(mflat), None, None))
    with torch.inference_mode():
        img, mask, st = calibrate_detector(tctx, t(chan), t(osv), t(osh),
                                           None, t(mflat), None, None)
    assert int(want_st["nsats"]) >= 1
    assert_exact(mask, want_mask)
    for k, v in want_st.items():
        if v.dtype.kind in "biu":
            assert_exact(st[k], v, k)
    atol = 1e-3 + 1e-5 * float(np.abs(want_st["biasm"]).max())
    assert_close(img, want_img, rtol=1e-5, atol=atol)
