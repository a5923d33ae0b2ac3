"""End-to-end parity of the port's per-frame reduction with the JAX
package: raw TINY frame -> calibrated mosaic + mask + stats + catalog,
both through ``make_reduce_fn`` with the same context and the same numpy
inputs (masters and crosstalk included; PSF stages off).

Tolerances.  Masks, labels, counts, ``nobjects`` and the catalog's
``valid``/``npix`` are exact.  Every float plane carries the float32
rounding of the overscan model, which removes a level L of ~1.7e4 e-
(max BIASM) from every pixel: the overscan stage alone already differs
by up to ~0.04 e- given identical inputs (tests/test_torch_ops.py
::test_overscan, an f32 normal-equation solve at that level).  So the
image, ``bkg`` and ``bkg_std`` are held at rtol 1e-5 with an atol of
1e-3 e- + 1e-5 L, and each catalog quantity at the same pixel atol
carried through its own linear map: aperture and isophotal fluxes
(rtol 1e-4) sum it over their pixels, centroids (atol 1e-3 px) move by
at most npix * atol * window / flux.
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import (assert_close, assert_exact, jax_ctx, n, t,  # noqa: E402
                          tiny_frame)
from blackbox_tpu.pipeline.reduce import make_reduce_fn as jax_make  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,  # noqa: E402
                                                make_reduce_fn)

# e- quantities of the stats dict (compared with the image tolerance)
E_STATS = ("biasm", "rdn", "biasmean", "rdnoise", "satlev", "saturate",
           "bkg_median", "bkg_std")
SHAPE_STATS = ("s_seeing_pix", "s_seestd_pix", "s_elong", "s_elostd")


@pytest.fixture(scope="module")
def reducers():
    ctx = jax_ctx()
    return (jax.jit(jax_make(ctx)),
            make_reduce_fn(ReduceContext.from_reference(ctx)), ctx)


def _structure(out):
    return {k: (_structure(v) if isinstance(v, dict)
                else (tuple(v.shape), str(n(v).dtype)))
            for k, v in out.items()}


@pytest.mark.parametrize("seed", [7, 2])
def test_reduce_matches_jax(reducers, seed):
    jfn, tfn, ctx = reducers
    chan, osv, osh, mbias, mflat, xt, _ = tiny_frame(seed)
    want = jax.tree_util.tree_map(np.asarray, jfn(
        *(jnp.asarray(a) for a in (chan, osv, osh, mbias, mflat)), None,
        jnp.asarray(xt)))
    got = tfn(t(chan), t(osv), t(osh), mbias, mflat, None, xt)

    assert _structure(got) == _structure(want)
    gs, ws = got["stats"], want["stats"]
    assert int(ws["ncosmics"]) > 0 and int(ws["nsats"]) >= 1
    assert_exact(got["mask"], want["mask"])
    assert_exact(got["seg_nsources"], want["seg_nsources"])
    for k, v in ws.items():
        if v.dtype.kind in "biu":
            assert_exact(gs[k], v, k)

    level = float(np.abs(ws["biasm"]).max())
    atol = 1e-3 + 1e-5 * level                     # e- per pixel
    for k in ("image", "bkg", "bkg_std"):
        assert_close(got[k], want[k], rtol=1e-5, atol=atol, what=k)
    for k in E_STATS:
        assert_close(gs[k], ws[k], rtol=1e-5, atol=atol, what=k)
    assert_close(gs["vfit_coef"], ws["vfit_coef"], rtol=0,
                 atol=1e-4 * level)                # the f32 solve itself
    for k in SHAPE_STATS:
        assert_close(gs[k], ws[k], rtol=1e-4, what=k)

    gc, wc = got["cat"], want["cat"]
    valid = wc["valid"]
    assert valid.sum() > 10
    assert_exact(gc["valid"], valid)
    assert_exact(n(gc["npix"])[valid], wc["npix"][valid])
    npix = wc["npix"][valid]
    flux_iso = wc["flux_iso"][valid]
    win = ctx.det_params.moment_window
    xy_atol = 1e-3 + npix * atol * win / np.maximum(np.abs(flux_iso), 1.0)
    for k in ("x", "y"):
        d = np.abs(n(gc[k])[valid] - wc[k][valid])
        assert np.all(d <= xy_atol), (k, d.max())
    assert_close(n(gc["flux_iso"])[valid], flux_iso, rtol=1e-4,
                 atol=float(npix.max()) * atol)
    assert_close(n(gc["peak"])[valid], wc["peak"][valid], rtol=1e-5,
                 atol=atol)
    area = np.array([math.pi * (r + 0.5) ** 2 for r in ctx.apphot_radii])
    for k in ("flux_ap", "fluxerr_ap"):
        d = np.abs(n(gc[k])[valid] - wc[k][valid])
        assert np.all(d <= 1e-4 * np.abs(wc[k][valid]) + area * atol), k


def test_reduce_refuses_unported_stages():
    ctx = ReduceContext.from_defaults(TINY, fit_psf=True)
    with pytest.raises(NotImplementedError, match="PSF"):
        make_reduce_fn(ctx)
    fn = make_reduce_fn(dataclasses.replace(ctx, fit_psf=False,
                                            detect_sat_segments=True))
    gen = torch.Generator().manual_seed(0)
    from blackbox_tpu_torch.synth.device import make_science_device
    chan, osv, osh, _ = make_science_device(gen, TINY, nstars=5,
                                            ncosmics=2, nsat=0)
    with pytest.raises(NotImplementedError, match="detect_sat_segments"):
        fn(chan, osv, osh, None, None, None, None)
