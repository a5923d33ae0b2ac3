"""Stage-by-stage parity of the port's ops with the JAX package.

Every port stage is fed the JAX stage's own input (a TINY frame from the
host generator run through the JAX chain), so differences do not pile
up.  Tolerances: integers, bools, masks, counts, labels and roots are
exact; order statistics (medians, peaks) are exact; float reductions
are compared at rtol 1e-5, since the two frameworks sum in other orders;
the polynomial fits and the overscan model at 1e-4 of the overscan
level, since they come from a float32 normal-equation solve.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import (assert_close, assert_exact, jax_ctx, n, t,  # noqa: E402
                          tiny_frame)
from blackbox_tpu.core import maskbits  # noqa: E402
from blackbox_tpu.core.geometry import TINY  # noqa: E402
from blackbox_tpu.ops import (background as jbg, cosmics as jcr,  # noqa: E402
                              detection as jdet, gain as jgain,
                              masking as jmask, morphology as jmorph,
                              overscan as jos, photometry as jphot,
                              polyfit as jpoly, satdet as jsat,
                              stats as jstats, xtalk as jxt)
from blackbox_tpu.pipeline.reduce import calibrate_detector  # noqa: E402
from blackbox_tpu_torch.ops import (background as tbg, cosmics as tcr,  # noqa: E402
                                    detection as tdet, gain as tgain,
                                    masking as tmask, morphology as tmorph,
                                    overscan as tos, photometry as tphot,
                                    polyfit as tpoly, satdet as tsat,
                                    stats as tstats, xtalk as txt)
from blackbox_tpu_torch.pipeline.reduce import ReduceContext  # noqa: E402


def _jax_chain(ctx, chan, osv, osh, mflat, xt):
    """The JAX calibration chain, returning every stage's input/output."""
    s = {}
    gains = jnp.asarray(ctx.gains, jnp.float32)
    satadu = jnp.asarray(ctx.satlevel_adu, jnp.float32)
    s["gain"] = jgain.gain_correct(chan, osv, osh, gains)
    c1, v1, h1 = s["gain"]
    s["os"] = jos.overscan_correct(c1, v1, h1, satlevel_e=satadu * gains,
                                   params=ctx.os_params)
    c2, os_stats = s["os"]
    s["mask"] = jmask.build_mask(c2, None, satadu, gains, os_stats["biasm"],
                                 nx=TINY.nx)
    c3, mask, _ = s["mask"]
    sci = TINY.assemble(c3 / jnp.maximum(mflat, 1e-3))
    s["lac_in"] = (sci, TINY.assemble(mask), os_stats["rdnoise"])
    s["lac"] = jcr.lacosmic(sci, s["lac_in"][1] != 0, os_stats["rdnoise"],
                            ctx.lac_params)
    clean, crmask, _ = s["lac"]
    s["xt_in"] = (clean, jnp.where(crmask, s["lac_in"][1] | maskbits.COSMIC,
                                   s["lac_in"][1]))
    # the fully calibrated frame feeds the catalog stages
    s["cal"] = calibrate_detector(ctx, chan, osv, osh, None, mflat, None,
                                  xt)[:2]
    return s


@pytest.fixture(scope="module")
def chain():
    """The JAX calibration chain on one TINY frame, stage by stage (one
    jitted program, as the JAX tests run it)."""
    ctx = jax_ctx()
    chan, osv, osh, _, mflat, xt, _ = tiny_frame(7)
    s = jax.jit(lambda *a: _jax_chain(ctx, *a))(
        *(jnp.asarray(a) for a in (chan, osv, osh, mflat, xt)))
    s = jax.tree_util.tree_map(np.asarray, s)
    s.update(ctx=ctx, raw=(chan, osv, osh), mflat=mflat, xt=xt,
             level=float(np.abs(s["os"][1]["biasm"]).max()))
    return s


def test_gain(chain):
    got = tgain.gain_correct(*(t(a) for a in chain["raw"]),
                             chain["ctx"].gains)
    for g, w in zip(got, chain["gain"]):
        assert_exact(g, w)


def test_overscan(chain):
    ctx = chain["ctx"]
    c1, v1, h1 = (t(a) for a in chain["gain"])
    gains = torch.tensor(ctx.gains)
    got, gst = tos.overscan_correct(
        c1, v1, h1, satlevel_e=torch.tensor(ctx.satlevel_adu) * gains,
        params=ReduceContext.from_reference(ctx).os_params)
    want, wst = chain["os"]
    atol = 1e-4 * chain["level"]       # the f32 solve at the bias level
    assert_close(got, want, rtol=0, atol=atol)
    for k in ("biasm", "rdn", "biasmean", "rdnoise", "vfit_coef"):
        assert_close(gst[k], wst[k], rtol=0, atol=atol, what=k)
    assert_exact(gst["vfit_ok"], wst["vfit_ok"])


def test_build_mask(chain):
    ctx = chain["ctx"]
    c2, os_stats = chain["os"]
    got = tmask.build_mask(t(c2), None, ctx.satlevel_adu, ctx.gains,
                           t(os_stats["biasm"]), nx=TINY.nx)
    want = chain["mask"]
    assert_exact(got[0], want[0])
    assert_exact(got[1], want[1])
    assert_exact(got[2]["satlev"], want[2]["satlev"])
    assert_exact(got[2]["mask_sat"], want[2]["mask_sat"])
    assert_close(got[2]["saturate"], want[2]["saturate"], rtol=1e-5)
    assert_exact(got[2]["n_infnan"], want[2]["n_infnan"])


def test_morphology(rng):
    m = rng.random((3, 40, 52)) > 0.7
    m[:, 10:20, 10:20] = True
    m[:, 14, 14] = False                      # a hole
    for it in (1, 3):
        got = tmorph.fill_holes(t(m), it)            # batched planes
        for gi, mi in zip(got, m):
            assert_exact(gi, jmorph.fill_holes(jnp.asarray(mi), it))
    got = tmorph.satcon_close_fill(t(m), 1)
    want = [jmorph.satcon_close_fill(jnp.asarray(mi), 1) for mi in m]
    assert_exact(got[0], np.stack([n(w[0]) for w in want]))
    assert_exact(got[1], np.stack([n(w[1]) for w in want]))


def test_stats(rng):
    x = rng.normal(10.0, 3.0, (6, 257)).astype(np.float32)
    x[:, :9] += 60.0                         # outliers to clip
    mask = rng.random(x.shape) > 0.8
    mask[2] = True                           # an all-masked row
    for axis in (None, 1):
        for mk in (None, mask):
            g = tstats.masked_mean_std(t(x), None if mk is None else t(mk),
                                       axis=axis, ddof=1)
            w = jstats.masked_mean_std(jnp.asarray(x), mk, axis=axis, ddof=1)
            for a, b in zip(g, w):
                assert_close(a, b, rtol=1e-5)
    assert_exact(tstats.masked_median(t(x), t(mask), axis=1),
                 jstats.masked_median(jnp.asarray(x), jnp.asarray(mask),
                                      axis=1))
    assert_exact(tstats.median(t(x), axis=1), jnp.median(x, axis=1))
    for axis in (None, 1):
        assert_exact(tstats.sigma_clip(t(x), t(mask), axis=axis, sigma=2.5),
                     jstats.sigma_clip(jnp.asarray(x), jnp.asarray(mask),
                                       axis=axis, sigma=2.5))
    g = tstats.sorted_clipped_stats(t(x), t(mask))
    w = jstats.sorted_clipped_stats(jnp.asarray(x), jnp.asarray(mask))
    assert_exact(g[0], w[0])                 # median: an order statistic
    assert_close(g[1], w[1], rtol=1e-5)
    assert_close(g[2], w[2], rtol=1e-5)
    assert_exact(g[3], w[3])


def test_polyfit(rng):
    xs = np.arange(300, dtype=np.float32)
    y = (16000.0 + 3.0 * np.sin(xs / 40.0)
         + rng.normal(0, 1, (4, 300))).astype(np.float32)
    w = (rng.random((4, 300)) > 0.1).astype(np.float32)
    w[3] = 0.0                                    # rank-deficient batch
    err = np.ones_like(y)
    atol = 1e-4 * 16000.0                         # f32 solve at the level
    g = tpoly.polyfit_w(t(xs), t(y), t(w), 3, 0.0, 299.0)
    ww = jpoly.polyfit_w(jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w), 3,
                         0.0, 299.0)
    assert_close(g, ww, rtol=0, atol=atol)
    assert_close(tpoly.polyval_norm(g, t(xs), 0.0, 299.0),
                 jpoly.polyval_norm(ww, jnp.asarray(xs), 0.0, 299.0),
                 rtol=0, atol=atol)
    g = tpoly.polyfit_reject(t(xs), t(y), t(w), 7, t(err), x0=0.0, x1=299.0)
    ww = jpoly.polyfit_reject(jnp.asarray(xs), jnp.asarray(y),
                              jnp.asarray(w), 7, jnp.asarray(err), x0=0.0,
                              x1=299.0)
    assert_close(g[2], ww[2], rtol=0, atol=atol)


def test_lacosmic(chain):
    sci, mask_m, rdnoise = chain["lac_in"]
    p = ReduceContext.from_reference(chain["ctx"]).lac_params
    got = tcr.lacosmic(t(sci), t(mask_m) != 0, t(rdnoise), p)
    want = chain["lac"]
    assert int(np.sum(n(want[1]))) > 0
    assert_exact(got[1], want[1])           # crmask
    assert_exact(got[0], want[0])           # replacements: order statistics
    assert_exact(got[2], want[2])           # per-round new detections


def test_xtalk(chain):
    clean, mask_m = chain["xt_in"]
    xt = chain["xt"]
    want = jxt.xtalk_correct_mosaic(clean, mask_m, xt, 2, TINY.nx)
    got = txt.xtalk_correct_mosaic(t(clean), t(mask_m), xt, 2, TINY.nx)
    assert_close(got, want, rtol=1e-5, atol=1e-3)
    ch = txt.xtalk_correct(t(TINY.disassemble(clean)),
                           t(TINY.disassemble(mask_m)), xt, TINY.nx)
    assert_close(ch, TINY.disassemble(want), rtol=1e-5, atol=1e-3)


def test_detect_trails(chain):
    ctx = chain["ctx"]
    sci, mask_m = chain["cal"]
    excl = (mask_m & (maskbits.SATURATED | maskbits.SAT_CONNECTED
                      | maskbits.BAD | maskbits.EDGE)) != 0
    Hr, Wr = TINY.red_shape
    seams = dict(seam_rows=(TINY.ysize_chan,),
                 seam_cols=tuple(TINY.xsize_chan * j
                                 for j in range(1, Wr // TINY.xsize_chan)))
    want = jsat.detect_trails(sci, excl, ctx.sat_params, **seams)
    got = tsat.detect_trails(t(sci), t(excl),
                             ReduceContext.from_reference(ctx).sat_params,
                             **seams)
    assert int(want[1]) >= 1
    assert_exact(got[0], want[0])
    assert_exact(got[1], want[1])
    assert_close(got[2], want[2], rtol=1e-4)


def test_background(chain):
    ctx = chain["ctx"]
    sci, mask_m = chain["cal"]
    bad = mask_m != 0
    want = jbg.background_mesh(sci, bad, ctx.bkg_boxsize,
                               nsigma=ctx.bkg_nsigma,
                               filtersize=ctx.bkg_filtersize)
    got = tbg.background_mesh(t(sci), t(bad), ctx.bkg_boxsize,
                              nsigma=ctx.bkg_nsigma,
                              filtersize=ctx.bkg_filtersize)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-5)
    assert_close(tbg.mini2back(t(want[0]), sci.shape, ctx.bkg_boxsize),
                 jbg.mini2back(want[0], sci.shape, ctx.bkg_boxsize),
                 rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def detected(chain):
    ctx = chain["ctx"]
    sci, mask_m = chain["cal"]
    mesh, stdm = jbg.background_mesh(sci, mask_m != 0, ctx.bkg_boxsize)
    sub = sci - jbg.mini2back(mesh, sci.shape, ctx.bkg_boxsize)
    bstd = jbg.mini2back(stdm, sci.shape, ctx.bkg_boxsize)
    excl = (mask_m & (maskbits.EDGE | maskbits.BAD
                      | maskbits.SATELLITE)) != 0
    seg, nsrc = jdet.detect_segments(sub, bstd, excl, ctx.det_params)
    cat = jdet.segment_catalog(sub, bstd, seg, nsrc, ctx.det_params)
    return sub, bstd, excl, seg, nsrc, cat


def test_detection(chain, detected):
    ctx = chain["ctx"]
    sub, bstd, excl, seg, nsrc, _ = detected
    dp = ReduceContext.from_reference(ctx).det_params
    assert_close(tdet.matched_filter(t(sub), dp.fwhm_filter)[0],
                 jdet.matched_filter(sub, dp.fwhm_filter)[0],
                 rtol=1e-5, atol=1e-3)
    got_seg, got_n = tdet.detect_segments(t(sub), t(bstd), t(excl), dp)
    assert int(nsrc) > 10
    assert_exact(got_seg, seg)
    assert_exact(got_n, nsrc)
    assert_exact(tdet.segment_roots(t(seg), dp.max_sources),
                 jdet.segment_roots(seg, dp.max_sources))


def test_segment_catalog_and_photometry(chain, detected):
    ctx = chain["ctx"]
    dp = ReduceContext.from_reference(ctx).det_params
    sub, bstd, _, seg, nsrc, want = detected
    got = tdet.segment_catalog(t(sub), t(bstd), t(seg), t(nsrc), dp)
    k = int(nsrc)                         # parity on the live slots
    assert_exact(got["valid"], want["valid"])
    for key in ("npix", "peak"):
        assert_exact(got[key][:k], n(want[key])[:k], key)
    for key in ("x", "y", "flux_iso", "x2", "y2", "xy"):
        assert_close(got[key][:k], n(want[key])[:k], rtol=1e-5, atol=1e-4,
                     what=key)
    # shape and photometry from the JAX catalog's own centroids
    shape_t = tdet.moments_shape({q: t(want[q]) for q in ("x2", "y2", "xy")})
    shape_j = jdet.moments_shape(want)
    for key in shape_j:
        assert_close(shape_t[key][:k], n(shape_j[key])[:k], rtol=1e-5,
                     atol=1e-5, what=key)
    flux, err = tphot.aperture_photometry(
        t(sub), t(bstd), t(want["x"]), t(want["y"]), ctx.apphot_radii,
        n_active=t(nsrc))
    wflux, werr = jphot.aperture_photometry(sub, bstd, want["x"], want["y"],
                                            ctx.apphot_radii, n_active=nsrc)
    assert_close(flux[:k], n(wflux)[:k], rtol=1e-5, atol=1e-3)
    assert_close(err[:k], n(werr)[:k], rtol=1e-5, atol=1e-3)
