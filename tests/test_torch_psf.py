"""Parity of the port's PSF fit and PSF photometry (ops/psf.py) with the
JAX package, on one star field whose FWHM varies across the frame.

Both sides get the same numpy inputs: the background-subtracted image,
its STD map and the fixed-capacity catalog (from the JAX detection
chain).  Tolerances: the star count of the fit is exact; the PSF basis
images are held at 1e-5 of the basis' largest value — they come out of
float32 normal equations (two matmuls over the stars, one 6 x 6 solve)
that the two frameworks sum in other orders, on vignettes that are
exact copies; chi² and the PSF fluxes at rtol 1e-4 (ratios of sums of
625 float32 products per star); live slots only (slots past the live
count are zero windows here and skipped chunks in JAX).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_close, assert_exact, n, t  # noqa: E402
from test_psf import _detect, _psf_field  # noqa: E402
from blackbox_tpu.ops import psf as jpsf  # noqa: E402
from blackbox_tpu_torch.ops import psf as tpsf  # noqa: E402


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(5)
    img, _ = _psf_field(rng)
    sub, bstd, cat = _detect(img)
    cat = {k: np.asarray(v) for k, v in cat.items()}
    return np.asarray(sub), np.asarray(bstd), cat


def _tcat(cat):
    return {k: t(v) for k, v in cat.items()}


@pytest.mark.parametrize("poldeg", [1, 2])
def test_build_psf_matches_jax(field, poldeg):
    sub, bstd, cat = field
    p = tpsf.PSFParams(size=25, poldeg=poldeg, snr_min=20.0)
    want = jpsf.build_psf(jnp.asarray(sub), jnp.asarray(bstd),
                          {k: jnp.asarray(v) for k, v in cat.items()},
                          sub.shape, jpsf.PSFParams(size=25, poldeg=poldeg,
                                                    snr_min=20.0))
    got = tpsf.build_psf(t(sub), t(bstd), _tcat(cat), sub.shape, p)
    assert int(want.nstars) >= 20
    assert_exact(got.nstars, want.nstars, "nstars")
    scale = float(np.abs(n(want.basis)).max())
    assert_close(got.basis, want.basis, rtol=0, atol=1e-5 * scale,
                 what="basis")
    assert_close(got.chi2, want.chi2, rtol=1e-4, what="chi2")
    for k in ("polzero_x", "polzero_y", "polscal_x", "polscal_y"):
        assert_exact(getattr(got, k), getattr(want, k), k)
    assert got.poldeg == want.poldeg

    # the carried-across model samples like the JAX one
    carried = tpsf.PSFModel.from_reference(want)
    xs, ys = cat["x"][:7], cat["y"][:7]
    assert_close(tpsf.psf_at(carried, t(xs), t(ys)),
                 jpsf.psf_at(want, jnp.asarray(xs), jnp.asarray(ys)),
                 rtol=1e-5, atol=1e-7, what="psf_at")
    cen_t = tpsf.psf_at(carried, 256.0, 256.0)
    cen_j = jpsf.psf_at(want, 256.0, 256.0)
    assert_close(tpsf.psf_fwhm(cen_t[None]), jpsf.psf_fwhm(cen_j[None]),
                 rtol=1e-5, what="psf_fwhm")


def test_psf_photometry_matches_jax(field):
    sub, bstd, cat = field
    model = jpsf.build_psf(jnp.asarray(sub), jnp.asarray(bstd),
                           {k: jnp.asarray(v) for k, v in cat.items()},
                           sub.shape, jpsf.PSFParams(size=25, poldeg=2))
    nact = int(cat["valid"].sum()) + 3
    want = jpsf.psf_photometry(jnp.asarray(sub), jnp.asarray(bstd), model,
                               jnp.asarray(cat["x"]), jnp.asarray(cat["y"]),
                               n_active=jnp.int32(nact))
    got = tpsf.psf_photometry(t(sub), t(bstd),
                              tpsf.PSFModel.from_reference(model),
                              t(cat["x"]), t(cat["y"]),
                              n_active=torch.tensor(nact))
    live = np.arange(len(cat["x"])) < nact
    for g, w, what in zip(got, want, ("flux", "fluxerr")):
        assert_close(n(g)[live], n(w)[live], rtol=1e-4, atol=1e-3,
                     what=what)
