"""Parity of the port's fused detection (ops/detection.fused_detect, the
plain version of the CUDA kernel csrc/detect.cu) with the JAX package's
Pallas kernel (pallas/detect.py, in interpret mode as its own tests run
it), and of the transient extraction (ops/transients.py) with the JAX
package's.

Tolerances.  Segment maps, counts, ``valid``/``vetted_out``/``sign``,
``npix`` and the peak pixels are exact: they are integer results of
comparisons on identical inputs (the matched filter sums the same taps
in the same order, and XLA's fusion of it rounds each product as
PyTorch does — the JAX package relies on that to keep its own fused
kernel bit-identical to its unfused chain).  The per-segment float
moments are held at rtol 1e-5: sums of at most 48² float32 products,
reduced in other orders.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_close, assert_exact, n, t  # noqa: E402
from test_pallas_detect import _scene  # noqa: E402
from blackbox_tpu.ops import transients as jtr  # noqa: E402
from blackbox_tpu.ops.detection import gaussian_taps  # noqa: E402
from blackbox_tpu.pallas.detect import fused_detect_pallas  # noqa: E402
from blackbox_tpu_torch.ops import detection as tdet  # noqa: E402
from blackbox_tpu_torch.ops import transients as ttr  # noqa: E402


def _detect_form(rng):
    H, W = 600, 560
    img = _scene(rng, H, W)
    img[0, 10] = img[H - 1, 50] = img[77, 0] = 300.0     # on the border
    std = rng.uniform(0.7, 1.3, (H, W)).astype(np.float32)
    excl = np.zeros((H, W), bool)
    excl[50:60, 100:120] = True
    return img, std, excl


@pytest.mark.parametrize("form", ["detect", "transient"])
def test_fused_detect_matches_pallas(form):
    """K5's plain version against the Pallas kernel: the detection form
    (9 taps, a std map, an exclusion zone, 32 steps) and the transient
    form (|x| against a scalar, no taps, 48 steps)."""
    rng = np.random.default_rng(17)
    if form == "detect":
        img, std, excl = _detect_form(rng)
        taps, nsigma, iters, absval = gaussian_taps(3.0), 1.5, 32, False
    else:
        H, W = 560, 540
        img = rng.normal(0, 1.0, (H, W)).astype(np.float32)
        img[100:104, 200:204] = 9.0
        img[300:303, 400:402] = -8.0
        img[400:460, 20:22] = 7.0        # longer than the 48 steps reach
        std = None
        excl = np.zeros((H, W), bool)
        excl[300:310, 395:410] = True
        taps, nsigma, iters, absval = None, 6.0, 48, True
    seg_w, n_w = fused_detect_pallas(
        jnp.asarray(img), None if std is None else jnp.asarray(std),
        jnp.asarray(excl), taps, nsigma, iters=iters, absval=absval,
        interpret=True)
    before = tdet.fused_detect.launches
    seg, cnt = tdet.fused_detect(t(img), None if std is None else t(std),
                                 t(excl), taps, nsigma, iters=iters,
                                 absval=absval)
    assert tdet.fused_detect.launches == before        # plain on the CPU
    assert int(n_w) > 0
    assert_exact(cnt, n_w, "n")
    assert_exact(seg, seg_w, "seg")


def test_detect_segments_fused_route_equals_unfused():
    """``use_pallas=True`` (the fused route, plain on the CPU) gives the
    unfused chain's segments; ``None`` never fuses off the card, even
    with BBTPU_PALLAS_DETECT=1."""
    rng = np.random.default_rng(4)
    img, std, excl = _detect_form(rng)
    p = tdet.DetectParams(label_iters=32)
    want = tdet.detect_segments(t(img), t(std), t(excl), p, use_pallas=False)
    got = tdet.detect_segments(t(img), t(std), t(excl), p, use_pallas=True)
    assert_exact(got[0], want[0], "seg")
    assert_exact(got[1], want[1], "n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BBTPU_PALLAS_DETECT", "1")
        assert tdet.pallas_detect_enabled()
        auto = tdet.detect_segments(t(img), t(std), t(excl), p)
    assert_exact(auto[0], want[0], "seg")


def _zogy_out(rng, H, W):
    sc = rng.normal(0, 1.0, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    blobs = [(40, 50, 30.0, 1.5, 1.5), (120, 200, -25.0, 1.2, 1.2),
             (90, 100, 18.0, 4.0, 0.8), (160, 60, 12.0, 1.0, 1.0),
             (20, 230, 40.0, 2.0, 2.0)]
    for y, x, a, sy, sx in blobs:
        sc += a * np.exp(-0.5 * (((yy - y) / sy) ** 2 + ((xx - x) / sx) ** 2))
    # a dipole: positive and negative lobes in one segment
    sc += 20.0 * np.exp(-0.5 * (((yy - 60) / 1.5) ** 2
                                + ((xx - 148) / 1.5) ** 2))
    sc -= 20.0 * np.exp(-0.5 * (((yy - 60) / 1.5) ** 2
                                + ((xx - 152) / 1.5) ** 2))
    sc = sc.astype(np.float32)
    d = (3.0 * sc + rng.normal(0, 0.1, (H, W))).astype(np.float32)
    fpsf = (50.0 * sc).astype(np.float32)
    ferr = rng.uniform(40, 60, (H, W)).astype(np.float32)
    return {"Scorr": sc, "D": d, "Fpsf": fpsf, "Fpsferr": ferr}


def test_extract_transients_matches_jax():
    rng = np.random.default_rng(8)
    H, W = 200, 260
    out = _zogy_out(rng, H, W)
    mask_new = np.zeros((H, W), np.uint8)
    mask_new[155:165, 55:65] = 64                 # EDGE over one source
    mask_ref = np.zeros((H, W), np.uint8)
    mask_ref[0:3, :] = 1
    kw = dict(max_transients=64, label_iters=16, moment_window=24)
    want_cat, want_n = jtr.extract_transients(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(mask_new),
        jnp.asarray(mask_ref), jtr.TransientParams(**kw))
    got_cat, got_n = ttr.extract_transients(
        {k: t(v) for k, v in out.items()}, t(mask_new), t(mask_ref),
        ttr.TransientParams(**kw))
    assert int(want_n) >= 3
    assert_exact(got_n, want_n, "n_transients")
    assert set(got_cat) == set(want_cat)
    wc = {k: np.asarray(v) for k, v in want_cat.items()}
    for k in ("valid", "vetted_out", "sign", "npix", "x", "y"):
        assert_exact(got_cat[k], wc[k], k)
    assert wc["vetted_out"].any()                 # the dipole and the trail
    live = wc["valid"] | wc["vetted_out"]
    for k in ("elong", "scorr_peak", "scorr_peak_abs", "flux_psf",
              "fluxerr_psf", "d_peak"):
        assert_close(n(got_cat[k])[live], wc[k][live], rtol=1e-5, atol=1e-6,
                     what=k)
    ws = jtr.transient_stats(want_cat, want_n)
    gs = ttr.transient_stats(got_cat, got_n)
    assert set(gs) == set(ws)
    for k in ws:
        assert_exact(gs[k], ws[k], k)
    assert gs["t_ntrans"].dtype == torch.int32


# ---- the schedule of csrc/detect.cu, modelled in PyTorch -----------------

STRIP_W = 128          # columns of one detect_scan strip


def _scan_model(img, std, excl, taps, nsigma, absval, T):
    """detect_scan of csrc/detect.cu in plain PyTorch: strips of T rows
    x 128 columns, each filtered from its own image region (the taps'
    r rows each side, and r rounded up to 4 columns each side, zero
    outside the frame), along columns and then along rows, then the
    threshold and the exclusion.  Returns the detection map."""
    H, W = img.shape
    x = img
    if taps is not None:
        r = (len(taps) - 1) // 2
        R = (r + 3) & ~3
        pad = torch.nn.functional.pad(img, (R, R + STRIP_W, r, r + T))
        x = torch.empty_like(img)
        for gy0 in range(0, H, T):
            for gx0 in range(0, W, STRIP_W):
                raw = pad[gy0:gy0 + T + 2 * r, gx0:gx0 + STRIP_W + 2 * R]
                vcol = torch.zeros((T, STRIP_W + 2 * R))
                for q, tq in enumerate(taps):
                    vcol = vcol + tq * raw[q:q + T]
                h = torch.zeros((T, STRIP_W))
                for q, tq in enumerate(taps):
                    h = h + tq * vcol[:, R - r + q:R - r + q + STRIP_W]
                hh, ww = min(T, H - gy0), min(STRIP_W, W - gx0)
                x[gy0:gy0 + hh, gx0:gx0 + ww] = h[:hh, :ww]
    if absval:
        x = torch.abs(x)
    det = (x > nsigma * torch.clamp(std, min=1e-6) if std is not None
           else x > nsigma)
    if excl is not None:
        det = det & ~excl
    return det


def _detect_model(img, std, excl, taps, nsigma, iters, absval):
    """csrc/detect.cu's two launches in plain PyTorch: the scan's
    detection map, seeds from it, then K1's listed-tile schedule
    (tests/test_torch_labeling.py) on the tiles with a detection; seg
    and the root count from its labels."""
    from test_torch_labeling import _schedule_model
    H, W = img.shape
    T = 32 if iters <= 60 else 16
    det = _scan_model(img, std, excl, taps, nsigma, absval, T)
    idx = torch.arange(1, H * W + 1, dtype=torch.int32).reshape(H, W)
    lab = _schedule_model(torch.where(det, idx, H * W + 2), iters)
    return (torch.where(lab < H * W + 2, lab, 0),
            torch.sum(lab == idx, dtype=torch.int32))


def _schedule_frame(kind, rng, H, W):
    """A frame for the schedule models: image, std map, exclusion."""
    img = rng.normal(0.0, 1.0, (H, W)).astype(np.float32)
    std = rng.uniform(0.8, 1.2, (H, W)).astype(np.float32)
    excl = np.zeros((H, W), bool)
    if kind == "empty":
        img[:] = 0.0
    elif kind == "full":
        img[:] = 50.0
    elif kind == "sparse":
        for y, x in ((10, 12), (40, 130), (70, 60)):
            img[y - 2:y + 3, x - 3:x + 4] += 30.0
    elif kind == "border":               # sources on every edge and corner
        img[0, 20:30] += 40.0
        img[H - 1, 100:140] += 40.0
        img[30:50, 0] += 40.0
        img[5:9, W - 1] += 40.0
        img[0, 0] = img[H - 1, W - 1] = 90.0
    elif kind == "nanstd":               # NaN and 0 in the std map
        img[20:26, 30:36] += 30.0
        std[22, 32] = np.nan
        std[50:53, 100:103] = 0.0
        std[rng.random((H, W)) < 0.02] = np.nan
        img[60, 70] = np.nan
    elif kind == "excl":                 # exclusions over and beside sources
        img[30:40, 20:60] += 30.0
        excl[33:36, :] = True
        excl[rng.random((H, W)) < 0.05] = True
    return img, std, excl


@pytest.mark.parametrize("iters", [1, 24, 32, 48, 56])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "border",
                                  "nanstd", "excl"])
def test_detect_schedule_model_matches_plain(iters, kind):
    """K5's scan (strips, the filter's staged halo, threshold, exclusion,
    tiles listed) and its listed-tile label steps, run as a PyTorch
    model, give the plain version's segments and root count exactly, in
    the detection form (9 taps, std map) and the transient form (|x|,
    no taps, no std), on a frame that is a multiple of neither the tile
    nor the strip."""
    rng = np.random.default_rng(iters * 7 + len(kind))
    img, std, excl = (t(a) for a in _schedule_frame(kind, rng, 75, 141))
    taps = tdet.gaussian_taps(3.0)
    for args in ((img, std, excl, taps, 1.5, iters, False),
                 (3.0 * img, None, excl, None, 6.0, iters, True)):
        want = tdet._fused_detect_plain(*args)
        got = _detect_model(*args)
        assert_exact(got[0], want[0], "seg")
        assert_exact(got[1], want[1], "n")
