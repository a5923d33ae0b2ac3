"""The rest of the calibration layer against the JAX package: the
L.A.Cosmic variants (separable medians, sparse clean), the
non-linearity correction, the master frames, the flat statistics, and
the reduction end to end under ``LACosmicParams(use_pallas=True)``.

Tolerances.  Masks, counts and cosmic-cleaned pixels are exact (order
statistics of the same inputs).  Medians of the master stacks are
exact (both take the mean of the two middle values); means, stds and
the GAINCF chain are sums in another order, held at rtol 1e-5.  The
non-linearity correction evaluates the same polynomial by other float32
steps (powers one at a time against XLA's ``pow`` and dot), rtol 1e-6.
The reductions carry the float32 rounding of the overscan level, so
they are held at tests/test_torch_reduce.py's tolerances.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import (assert_close, assert_exact, cosmic_scene,  # noqa: E402
                          jax_ctx, n, t, tiny_frame)
from test_torch_reduce import _check_reduce  # noqa: E402
from blackbox_tpu.core.geometry import TINY as JTINY  # noqa: E402
from blackbox_tpu.ops import cosmics as jcos  # noqa: E402
from blackbox_tpu.ops.flatstats import flat_statistics as jflatstats  # noqa: E402
from blackbox_tpu.ops.nonlin import nonlin_correct as jnonlin  # noqa: E402
from blackbox_tpu.pipeline import masters as jmasters  # noqa: E402
from blackbox_tpu.pipeline.reduce import calibrate_detector as jcalibrate  # noqa: E402
from blackbox_tpu.pipeline.reduce import make_reduce_fn as jax_make  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.ops import cosmics  # noqa: E402
from blackbox_tpu_torch.ops.flatstats import flat_statistics  # noqa: E402
from blackbox_tpu_torch.ops.nonlin import nonlin_correct  # noqa: E402
from blackbox_tpu_torch.pipeline import masters  # noqa: E402
from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,  # noqa: E402
                                                calibrate_detector,
                                                make_reduce_fn)

H, W = TINY.red_shape
NORM_SEC = (slice(H // 2 - H // 8, H // 2 + H // 8),
            slice(W // 2 - W // 8, W // 2 + W // 8))


def _nonlin_coeffs():
    """A fixed, small (C, 3) fractional correction: -0.2% to +0.5%."""
    c = np.linspace(-1.0, 1.0, TINY.n_chan, dtype=np.float32)[:, None]
    return np.concatenate([1e-3 + 5e-4 * c, 2e-3 + 0 * c, 1e-3 * c ** 2],
                          axis=1).astype(np.float32)


# ---- L.A.Cosmic variants ----------------------------------------------

@pytest.mark.parametrize("kw, rdn", [
    (dict(sepmed=True, windowed=False), 6.0),
    (dict(clean_cap=64, windowed=False), 6.0),
    (dict(clean_cap=3, windowed=False), 6.0),        # cap below the count
    (dict(clean_cap=64), "map"),                     # map -> unwindowed
    (dict(clean_cap=64), 6.0),                       # windowed: dense clean
])
def test_lacosmic_variants_match_jax(kw, rdn):
    img = cosmic_scene(11, H, W, 30, nstars=12)
    inmask = np.zeros((H, W), bool)
    inmask[40:52, 100:130] = True
    rd = np.full((H, W), 6.0, np.float32) if rdn == "map" else np.float32(rdn)
    want = jax.jit(lambda a, m, r: jcos.lacosmic(
        a, m, r, jcos.LACosmicParams(strip_rows=66, **kw)))(
            jnp.asarray(img), jnp.asarray(inmask), jnp.asarray(rd))
    got = cosmics.lacosmic(t(img), t(inmask), t(rd),
                           cosmics.LACosmicParams(strip_rows=66, **kw))
    assert int(np.asarray(want[2])[0]) > 0
    assert_exact(got[1], want[1], "crmask")
    assert_exact(got[2], want[2], "counts")
    assert_exact(got[0], want[0], "clean")


def test_median_filter_sep_matches_jax():
    from blackbox_tpu.ops.filters import median_filter_sep as jsep
    from blackbox_tpu_torch.ops.filters import median_filter_sep
    rng = np.random.default_rng(5)
    img = rng.normal(100.0, 10.0, (37, 53)).astype(np.float32)
    img[18, 20] = np.nan
    for k in (3, 5, 7):
        assert_exact(median_filter_sep(t(img), k, 8), jsep(img, k, 8), k)


# ---- non-linearity, masters, flat statistics ---------------------------

def test_nonlin_correct_matches_jax():
    rng = np.random.default_rng(1)
    C, ych, xch = TINY.chan_shape
    gains = np.resize(np.float32(2.1), C).astype(np.float32)
    chan = rng.uniform(-50.0, 1.2e5, (C, ych, xch)).astype(np.float32)
    coeffs = _nonlin_coeffs()
    want = np.asarray(jnonlin(jnp.asarray(chan), jnp.asarray(gains),
                              jnp.asarray(coeffs)))
    got = nonlin_correct(t(chan), t(gains), t(coeffs))
    assert_close(got, want, rtol=1e-6)
    above = chan / gains[:, None, None] >= 50000.0
    assert above.any() and (want != chan)[~above].mean() > 0.9
    assert_exact(n(got)[above], chan[above])


def _stack(seed, N, kind):
    """N calibrated TINY channel stacks: bias-like (0 e- +- 10) or
    flat-like (2e4 e- times a vignetted, channel-gain-stepped flat)."""
    rng = np.random.default_rng(seed)
    C, ych, xch = TINY.chan_shape
    if kind == "bias":
        return rng.normal(0.0, 10.0, (N, C, ych, xch)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    vign = 1.0 - 0.06 * (((yy - H / 2) / (H / 2)) ** 2
                         + ((xx - W / 2) / (W / 2)) ** 2)
    flat = np.stack([np.asarray(TINY.disassemble(t(vign.astype(np.float32))))
                     ] * N)
    flat *= (1.0 + 0.01 * np.arange(C))[None, :, None, None]
    level = 2e4 * (1.0 + 0.05 * np.arange(N))[:, None, None, None]
    return (flat * level + rng.normal(0.0, 140.0, flat.shape)).astype(
        np.float32)


@pytest.mark.parametrize("N", [3, 4])
def test_master_bias_and_dark_match_jax(N):
    stack = _stack(N, N, "bias")
    mj, sj = jmasters.master_bias(jnp.asarray(stack))
    mt, st = masters.master_bias(t(stack))
    assert_exact(mt, mj)
    for k in sj:
        assert_close(st[k], sj[k], rtol=1e-5, atol=1e-6, what=k)
    exptimes = np.linspace(30.0, 60.0, N).astype(np.float32)
    mj, sj = jmasters.master_dark(jnp.asarray(stack), jnp.asarray(exptimes))
    mt, st = masters.master_dark(t(stack), t(exptimes))
    assert_exact(mt, mj)
    for k in sj:
        assert_close(st[k], sj[k], rtol=1e-5, atol=1e-6, what=k)


@pytest.mark.parametrize("N", [3, 4])
def test_master_flat_matches_jax(N):
    stack = _stack(10 + N, N, "flat")
    bpm = np.zeros(TINY.chan_shape, np.uint8)
    bpm[:, :2, :] = 32                               # maskbits.EDGE
    mj, sj = jmasters.master_flat(jnp.asarray(stack), JTINY, NORM_SEC,
                                  bpm=jnp.asarray(bpm))
    mt, st = masters.master_flat(t(stack), TINY, NORM_SEC, bpm=t(bpm))
    assert_exact(mt, mj)
    assert_exact(st["medsec"], sj["medsec"])
    assert int(st["nmflat"]) == int(sj["nmflat"]) == N
    for k in ("gaincf", "mflat_med"):
        assert_close(st[k], sj[k], rtol=1e-5, what=k)
    assert abs(float(st["gaincf"].mean()) - 1.0) < 1e-5


def test_flat_statistics_match_jax():
    rng = np.random.default_rng(2)
    mosaic = (2e4 * (1.0 + 0.02 * rng.standard_normal((H, W)))).astype(
        np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.97).astype(np.uint8)
    subsize = max(min(H, W) // 8, 8)
    want = jflatstats(jnp.asarray(mosaic), jnp.asarray(mask), JTINY,
                      NORM_SEC, subsize)
    got = flat_statistics(t(mosaic), t(mask), TINY, NORM_SEC, subsize)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind in "iu":
            assert int(got[k]) == int(w), k
        else:
            assert_close(got[k], w, rtol=1e-5, what=k)


# ---- calibration and the reduction end to end ------------------------

def _calib_ctx(**overrides):
    """The test context with the stages these tests do not look at made
    cheap to compile: no trail search, one unwindowed L.A.Cosmic round."""
    ctx = jax_ctx(detect_sats=False, **overrides)
    return dataclasses.replace(ctx, lac_params=dataclasses.replace(
        ctx.lac_params, niter=1, windowed=False))


def test_calibrate_detector_nonlin_matches_jax():
    """``correct_nonlin`` with coefficients, on the CPU, against the JAX
    package's calibration (which applies it after overscan)."""
    ctx = _calib_ctx(correct_nonlin=True)
    tctx = ReduceContext.from_reference(ctx)
    chan, osv, osh, _, mflat, _, _ = tiny_frame(7)
    coeffs = _nonlin_coeffs()
    want_img, want_mask, want_st = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda *a: jcalibrate(ctx, *a))(
            *(jnp.asarray(a) for a in (chan, osv, osh)), None,
            jnp.asarray(mflat), None, None, jnp.asarray(coeffs)))
    with torch.inference_mode():
        img, mask, st = calibrate_detector(tctx, t(chan), t(osv), t(osh),
                                           None, t(mflat), None, None,
                                           nonlin_coeffs=coeffs)
        plain, _, _ = calibrate_detector(tctx, t(chan), t(osv), t(osh),
                                         None, t(mflat), None, None)
    level = float(np.abs(want_st["biasm"]).max())
    atol = 1e-3 + 1e-5 * level
    assert_exact(mask, want_mask)
    assert_close(img, want_img, rtol=1e-5, atol=atol)
    for k, v in want_st.items():
        if v.dtype.kind in "biu":
            assert_exact(st[k], v, k)
    # the correction moved the image well beyond the tolerance
    assert float((img - plain).abs().max()) > 100 * atol


def test_reduce_without_catalog_matches_jax():
    ctx = _calib_ctx()
    chan, osv, osh, mbias, mflat, xt, _ = tiny_frame(2)
    want = jax.tree_util.tree_map(np.asarray, jax_make(ctx, False)(
        *(jnp.asarray(a) for a in (chan, osv, osh, mbias, mflat)), None,
        jnp.asarray(xt)))
    got = make_reduce_fn(ReduceContext.from_reference(ctx),
                         with_catalog=False, device="cpu")(
        chan, osv, osh, mbias, mflat, None, xt)
    assert set(got) == set(want) == {"image", "mask", "stats"}
    assert set(got["stats"]) == set(want["stats"])
    assert_exact(got["mask"], want["mask"])
    level = float(np.abs(want["stats"]["biasm"]).max())
    assert_close(got["image"], want["image"], rtol=1e-5,
                 atol=1e-3 + 1e-5 * level)


def test_reduce_use_pallas_matches_jax(monkeypatch):
    """The slice end to end: ``make_reduce_fn`` with
    ``LACosmicParams(use_pallas=True)`` (K7's plain version on the CPU)
    against the JAX reduction with the same context, its fused Pallas
    iteration run in interpret mode."""
    import blackbox_tpu.pallas.lacosmic as jlac
    monkeypatch.setattr(jlac, "lacosmic_pallas", functools.partial(
        jlac.lacosmic_pallas, interpret=True))
    base = jax_ctx()
    ctx = dataclasses.replace(base, lac_params=dataclasses.replace(
        base.lac_params, use_pallas=True))
    tctx = ReduceContext.from_reference(ctx)
    assert tctx.lac_params.use_pallas
    import blackbox_tpu_torch.ops.lacosmic_fused as tlac
    calls = []

    def spy(*a, **kw):
        calls.append(kw)
        return fused(*a, **kw)

    fused = tlac.lacosmic_fused
    monkeypatch.setattr(tlac, "lacosmic_fused", spy)
    got, _ = _check_reduce(jax.jit(jax_make(ctx)),
                           make_reduce_fn(tctx, device="cpu"), ctx, 7)
    assert len(calls) == 1 and calls[0]["niter"] == ctx.lac_params.niter
    assert int(got["stats"]["ncosmics"]) > 0
