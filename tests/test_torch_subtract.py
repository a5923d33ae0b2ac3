"""Parity of the port's WCS remap and ``run_subtraction`` with the JAX
package on the CPU.

The WCS grids are computed in host float64 numpy by both packages, held
equal exactly.  The gather resamplers (``lanczos_resample``,
``nearest_resample``, ``resample_blocked``) are float32 tap sums in
the same order, held at rtol 1e-5 (nearest samples exactly).

``run_subtraction`` is run on both of its remap branches with the same
inputs in both packages: the new and reference products of
``tests/test_subtract.py``'s scene are measured once by the JAX
package and handed to both.
- the reference pointing shifted by a few pixels: the two-pass
  shifted adds (``warp_shift2pass``);
- the 3-degree rotated reference of ``tests/test_subtract.py``: the
  exact row-blocked gathers (``resample_blocked``).
The host statistics (the flux-ratio match and the registration rms)
and the transient counts are exact; ``z_fd`` and ``z_scorr_std`` are
float32 reductions of the device maps, held at rtol 1e-4 and 1e-3.
D and Scorr are compared as in ``test_torch_science.py``: D at 2e-4
of its largest value, Scorr at ``SCORR_RTOL`` of itself plus
``SCORR_ATOL``, the transients' peak pixels exactly but for
``peak_ties``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_close, assert_exact, n, t  # noqa: E402
from test_torch_science import (SCORR_ATOL, SCORR_RTOL,  # noqa: E402
                                peak_ties)
from blackbox_tpu.astro.wcs import TanWCS as JWCS  # noqa: E402
from blackbox_tpu.ops import warp as jwarp  # noqa: E402
from blackbox_tpu.ops.background import background_mesh, mini2back  # noqa: E402
from blackbox_tpu.ops.detection import (DetectParams,  # noqa: E402
                                        detect_segments, moments_shape,
                                        segment_catalog)
from blackbox_tpu.ops.photometry import aperture_photometry  # noqa: E402
from blackbox_tpu.ops.psf import (PSFParams, build_psf,  # noqa: E402
                                  psf_photometry)
from blackbox_tpu.pipeline import subtract as jsub  # noqa: E402
from blackbox_tpu.synth.generator import star_image  # noqa: E402
from blackbox_tpu_torch.astro.wcs import TanWCS  # noqa: E402
from blackbox_tpu_torch.ops import warp as twarp  # noqa: E402
from blackbox_tpu_torch.ops.psf import PSFModel  # noqa: E402
from blackbox_tpu_torch.pipeline import subtract as tsub  # noqa: E402

H = W = 256
PIXSCALE = 0.5642
# reference pointings against the new frame's (150, -30): a few pixels
# off (the two-pass branch) and tests/test_subtract.py's 3-degree turn
# (the gather branch)
REFS = {"shift2pass": (150.0 + 1.9 / 3600, -30.0 - 1.2 / 3600, 0.0),
        "blocked": (150.0015, -29.9985, 3.0)}


def _wcs_pair(kind, cls=JWCS, shape=(H, W)):
    ra, dec, rot = REFS[kind]
    return (cls.simple(150.0, -30.0, PIXSCALE, shape),
            cls.simple(ra, dec, PIXSCALE, shape, rot_deg=rot))


@pytest.mark.parametrize("kind", sorted(REFS))
def test_remap_grids_copy(kind):
    wn, wr = _wcs_pair(kind)
    for y0 in (0, 64):
        want = jwarp.remap_grid(wr, wn, (128, W), step=32, y0=y0)
        got = twarp.remap_grid(wr, wn, (128, W), step=32, y0=y0)
        for g, w in zip(got, want):
            assert_exact(g, w)
        want = jwarp.remap_grid_coarse(wr, wn, (128, W), step=32, y0=y0)
        got = twarp.remap_grid_coarse(wr, wn, (128, W), step=32, y0=y0)
        for g, w in zip(got, want):
            assert_exact(g, w)


def _planes(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 10.0, (H, W)).astype(np.float32)
    img += star_image((H, W), np.stack([rng.uniform(10, W - 10, 30),
                                        rng.uniform(10, H - 10, 30),
                                        rng.uniform(1e3, 3e4, 30),
                                        np.full(30, 3.0)], 1))
    mask = (rng.random((H, W)) < 0.05).astype(np.uint8) * 4
    return img.astype(np.float32), mask


@pytest.mark.parametrize("kind", sorted(REFS))
def test_gather_resamplers_match_jax(kind):
    img, mask = _planes(1)
    wn, wr = _wcs_pair(kind)
    ys, xs = jwarp.remap_grid(wr, wn, (H, W))
    want = jwarp.lanczos_resample(jnp.asarray(img), jnp.asarray(ys),
                                  jnp.asarray(xs), fill=-1.0)
    got = twarp.lanczos_resample(t(img), t(ys), t(xs), fill=-1.0)
    assert_close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(img).max()))
    for src in (img, mask):
        want = jwarp.nearest_resample(jnp.asarray(src), jnp.asarray(ys),
                                      jnp.asarray(xs), fill=64)
        got = twarp.nearest_resample(t(src), t(ys), t(xs), fill=64)
        assert_exact(got, want)
    # the one-call remap
    assert_close(twarp.remap(t(img), TanWCS(**vars(wr)), TanWCS(**vars(wn)),
                             (H, W)),
                 jwarp.remap(jnp.asarray(img), wr, wn, (H, W)), rtol=1e-5,
                 atol=1e-5 * float(np.abs(img).max()))


@pytest.mark.parametrize("form", ["coarse", "planes"])
def test_resample_blocked_matches_jax(form):
    img, mask = _planes(2)
    std = np.full((H, W), 7.0, np.float32)
    wn, wr = _wcs_pair("blocked")
    if form == "coarse":
        grid = jwarp.remap_grid_coarse(wr, wn, (H, W), step=32)
    else:
        grid = jwarp.remap_grid(wr, wn, (H, W), step=32)
    margin = jwarp.grid_row_margin(
        jwarp.remap_grid_coarse(wr, wn, (H, W), step=32)[0], step=32)
    modes = ("lanczos", "nearest", "nearest")
    fills = (0.0, 3.0, 64)
    want = jwarp.resample_blocked(
        tuple(jnp.asarray(a) for a in (img, std, mask)), modes, fills,
        tuple(jnp.asarray(g) for g in grid), block_rows=64, margin=margin)
    got = twarp.resample_blocked((t(img), t(std), t(mask)), modes, fills,
                                 grid, block_rows=64, margin=margin)
    assert_close(got[0], want[0], rtol=1e-5,
                 atol=1e-5 * float(np.abs(img).max()))
    assert_exact(got[1], want[1])
    assert_exact(got[2], want[2])
    with pytest.raises(ValueError, match="block_rows"):
        twarp.resample_blocked((t(img),), ("lanczos",), (0.0,), grid,
                               block_rows=100)


def _product(img, wcs):
    """tests/test_subtract.py::_product: detection and PSF fit of one
    synthetic frame by the JAX package, as numpy arrays and the model."""
    mesh, stdm = background_mesh(jnp.asarray(img), None, 64)
    bkg = mini2back(mesh, img.shape, 64)
    bstd = mini2back(stdm, img.shape, 64)
    sub = jnp.asarray(img) - bkg
    params = DetectParams(nsigma=2.0, max_sources=256, label_iters=32)
    seg, nn = detect_segments(sub, bstd, None, params)
    cat = segment_catalog(sub, bstd, seg, nn, params)
    cat.update(moments_shape(cat))
    flux, ferr = aperture_photometry(sub, bstd, cat["x"], cat["y"],
                                     (2.0, 5.0, 12.0))
    cat["snr"] = flux[:, -1] / jnp.maximum(ferr[:, -1], 1e-9)
    model = build_psf(sub, bstd, cat, img.shape,
                      PSFParams(size=25, poldeg=1, snr_min=10.0))
    fpsf, fpsferr = psf_photometry(sub, bstd, model, cat["x"], cat["y"])
    return dict(image=img, bkg=np.asarray(bkg), bkg_std=np.asarray(bstd),
                mask=np.zeros(img.shape, np.uint8), psf=model, wcs=wcs,
                cat_x=np.asarray(cat["x"]), cat_y=np.asarray(cat["y"]),
                cat_flux=np.asarray(fpsf), cat_fluxerr=np.asarray(fpsferr),
                cat_valid=np.asarray(cat["valid"]))


TRANS = (101.4, 166.8, 4.0e4)
FRATIO = 1.8


@pytest.fixture(scope="module", params=sorted(REFS))
def subtraction(request):
    """tests/test_subtract.py's scene with the reference at REFS[kind],
    run through both packages' run_subtraction."""
    kind = request.param
    rng = np.random.default_rng(42)
    w_new, w_ref = _wcs_pair(kind)
    nstars = 25
    xn = rng.uniform(30, W - 30, nstars)
    yn = rng.uniform(30, H - 30, nstars)
    fl = np.exp(rng.uniform(np.log(8e3), np.log(8e4), nstars))
    ra, dec = w_new.pix2sky(xn, yn)
    xr, yr = w_ref.sky2pix(ra, dec)
    stars_n = np.stack([xn, yn, fl, np.full(nstars, 3.2)], 1)
    stars_r = np.stack([xr, yr, fl * FRATIO, np.full(nstars, 2.6)], 1)
    tx, ty, tf = TRANS
    base_n = star_image((H, W), stars_n, moffat_beta=20.0) + 60.0
    base_n += star_image((H, W), [[tx, ty, tf, 3.2]], moffat_beta=20.0)
    base_r = star_image((H, W), stars_r, moffat_beta=20.0) + 110.0
    img_n = rng.poisson(base_n).astype(np.float32)
    img_r = rng.poisson(base_r).astype(np.float32)
    sides = [_product(img_n, w_new), _product(img_r, w_ref)]

    def jax_side(p):
        return jsub.SubtractionInput(**{
            k: jnp.asarray(v) if k in ("image", "bkg", "bkg_std", "mask")
            else v for k, v in p.items()})

    def port_side(p):
        kw = {k: t(v) if k in ("image", "bkg", "bkg_std", "mask") else v
              for k, v in p.items()}
        kw["psf"] = PSFModel.from_reference(p["psf"])
        kw["wcs"] = TanWCS(**vars(p["wcs"]))
        return tsub.SubtractionInput(**kw)

    want = jsub.run_subtraction(*(jax_side(p) for p in sides))
    calls = []
    saved = {f: getattr(tsub, f) for f in ("warp_shift2pass",
                                           "resample_blocked")}

    def recorder(name):
        def call(*args, **kw):
            calls.append(name)
            return saved[name](*args, **kw)
        return call

    try:
        for f in saved:
            setattr(tsub, f, recorder(f))
        got = tsub.run_subtraction(*(port_side(p) for p in sides))
    finally:
        for f, fn in saved.items():
            setattr(tsub, f, fn)
    got.remaps = calls
    return kind, want, got, sides


def test_run_subtraction_branch(subtraction):
    """Each scene takes the remap it was built for, and the port's
    remapped ref equals the JAX package's and that JAX resampler's
    output run directly."""
    kind, want, got, sides = subtraction
    assert got.remaps == [{"shift2pass": "warp_shift2pass",
                           "blocked": "resample_blocked"}[kind]]
    new, ref = sides
    step = 32
    sy, sx, _, _ = jwarp.remap_grid_coarse(ref["wcs"], new["wcs"], (H, W),
                                           step=step)
    ranges = jwarp.grid_shift_ranges(sy, sx, step=step, blocks=8)
    src = jnp.asarray(ref["image"] - ref["bkg"])
    if kind == "shift2pass":
        r = jwarp.warp_shift2pass(
            (src,), ("lanczos",), (0.0,),
            (jnp.asarray(sy, jnp.float32), jnp.asarray(sx, jnp.float32),
             step), ranges)[0]
    else:
        ys, xs = jwarp.remap_grid(ref["wcs"], new["wcs"], (H, W), step=step)
        r = jwarp.resample_blocked(
            (src,), ("lanczos",), (0.0,), (jnp.asarray(ys), jnp.asarray(xs)),
            block_rows=64,
            margin=max(jwarp.grid_row_margin(sy, step=step), 16))[0]
    scale = float(np.abs(np.asarray(r)).max())
    assert_close(got.ref_remapped, want.ref_remapped, rtol=0,
                 atol=1e-5 * scale)
    assert_close(got.ref_remapped, r, rtol=0, atol=1e-5 * scale)


def test_run_subtraction_matches_jax(subtraction):
    kind, want, got, _ = subtraction
    ws, gs = want.stats, got.stats
    assert set(gs) == set(ws)
    assert abs(ws["z_fratio"] / FRATIO - 1) < 0.1, ws
    for k in ("z_fratio", "z_fratio_std", "z_dxrms", "z_dyrms", "z_nmatch",
              "t_ntrans", "t_npos", "t_nneg", "t_nvetted"):
        assert gs[k] == ws[k], (k, gs[k], ws[k])
        assert type(gs[k]) is type(ws[k]), k
    assert gs["z_fd"] == pytest.approx(ws["z_fd"], rel=1e-4)
    assert gs["z_scorr_std"] == pytest.approx(ws["z_scorr_std"], rel=1e-3)

    D_w, S_w = np.asarray(want.D), np.asarray(want.Scorr)
    assert_close(got.D, D_w, rtol=0, atol=2e-4 * float(np.abs(D_w).max()),
                 what="D")
    assert_close(got.Scorr, S_w, rtol=SCORR_RTOL, atol=SCORR_ATOL,
                 what="Scorr")

    wc = {k: np.asarray(v) for k, v in want.trans_cat.items()}
    gc = {k: n(v) for k, v in got.trans_cat.items()}
    for k in ("valid", "vetted_out", "sign", "npix"):
        assert_exact(gc[k], wc[k], k)
    live = wc["valid"]
    assert live.sum() >= 1
    gx, gy = gc["x"][live], gc["y"][live]
    wx, wy = wc["x"][live].copy(), wc["y"][live].copy()
    for i in peak_ties((gx, gy), (wx, wy), S_w):
        wx[i], wy[i] = gx[i], gy[i]
    assert_exact(gx, wx, "x")
    assert_exact(gy, wy, "y")
    # the transient itself
    tx, ty, tf = TRANS
    d = np.where(live, np.hypot(gc["x"] - tx, gc["y"] - ty), np.inf)
    i = int(np.argmin(d))
    assert d[i] < 1.5 and gc["sign"][i] > 0
    assert abs(float(gc["flux_psf"][i]) / tf - 1) < 0.12


def test_run_subtraction_stays_on_the_inputs_device(subtraction):
    _, _, got, _ = subtraction
    for v in (got.D, got.Scorr, got.Fpsf, got.Fpsferr, got.ref_remapped,
              *got.trans_cat.values()):
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
