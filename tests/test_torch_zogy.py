"""Parity of the port's ZOGY subtraction (ops/zogy.py) with the JAX
package's, by both transform routes: ``"split"`` (the port's split-real
FFT, the plain version of the CUDA kernel on the CPU, against the Pallas
kernel in interpret mode) and ``"xla"`` (torch.fft against jnp.fft).

Tolerances.  D, S and Fpsf are held at 2e-4 of their own largest value,
the JAX package's own bound between its routes (tests/test_zogy.py):
float32 transform chains summed in other orders.  F_D and F_S at rtol
1e-5 (scalar sums).  Scorr carries V[S], whose source term is a float32
convolution of the image with squared kernels; it is held to a float64
evaluation of the same statistic (tests/test_zogy_oracle.py) within
twice the JAX package's own distance from it, and to the JAX package
at 3e-3 sigma + 5% (tests/test_torch_science.py explains the 5%).  The
small DFT builders (OTFs, stamps) are held at 2e-6 absolute, as the
JAX package holds them against numpy.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_close, assert_exact, n, t  # noqa: E402
from test_zogy_oracle import _gauss_psf, _scene, zogy_oracle64  # noqa: E402
from blackbox_tpu.ops import zogy as jz  # noqa: E402
from blackbox_tpu_torch import kernels  # noqa: E402
from blackbox_tpu_torch.ops import fft as tfft  # noqa: E402
from blackbox_tpu_torch.ops import zogy as tz  # noqa: E402

SN, SR, FR = np.sqrt(50.0), np.sqrt(36.0), 1.15


def _inputs(H, W, seed=0):
    rng = np.random.default_rng(seed)
    new, ref = _scene(rng, H, W)
    pn, pr = _gauss_psf(25, 3.1), _gauss_psf(25, 2.6)
    vbn = np.full((H, W), SN ** 2, np.float32)
    vbr = (SR ** 2 * rng.uniform(0.9, 1.1, (H, W))).astype(np.float32)
    return new, ref, pn, pr, vbn, vbr


def _run(new, ref, pn, pr, vbn, vbr, **params):
    kw = dict(fn=1.0, fr=FR)
    want = jz.zogy_subtract(jnp.asarray(new), jnp.asarray(ref),
                            jnp.asarray(pn), jnp.asarray(pr), SN, SR,
                            var_bkg_new=jnp.asarray(vbn),
                            var_bkg_ref=jnp.asarray(vbr),
                            params=jz.ZogyParams(**params), **kw)
    got = tz.zogy_subtract(t(new), t(ref), t(pn), t(pr), SN, SR,
                           var_bkg_new=t(vbn), var_bkg_ref=t(vbr),
                           params=tz.ZogyParams(**params), **kw)
    return {k: np.asarray(v) for k, v in want.items()}, got


@pytest.mark.parametrize("fft", ["split", "xla"])
@pytest.mark.parametrize("shape,stamp", [((120, 120), 256),
                                         ((200, 232), 64)])
def test_zogy_subtract_matches_jax(fft, shape, stamp):
    """Both routes, with the full-frame squared kernels (120², stamp
    larger than the frame) and with the production K x K aliased stamps
    (200 x 232, K = 64)."""
    H, W = shape
    args = _inputs(H, W)
    want, got = _run(*args, fft=fft, kernel_stamp=stamp)
    for k in ("D", "S", "Fpsf"):
        scale = float(np.abs(want[k]).max())
        assert_close(got[k], want[k], rtol=0, atol=2e-4 * scale, what=k)
    for k in ("F_D", "F_S"):
        assert_close(got[k], want[k], rtol=1e-5, what=k)
    assert_close(got["Scorr"], want["Scorr"], rtol=0.05, atol=3e-3,
                 what="Scorr")
    assert_close(got["psf_D"], want["psf_D"], rtol=0, atol=2e-6,
                 what="psf_D")


@pytest.mark.parametrize("fft", ["split", "xla"])
def test_zogy_subtract_as_accurate_as_jax(fft):
    H = W = 120
    new, ref, pn, pr, vbn, vbr = _inputs(H, W, seed=1)
    want, got = _run(new, ref, pn, pr, vbn, vbr, fft=fft)
    size = tz.split_fft_size if fft == "split" else tz.fast_fft_size
    pad = ((0, size(H) - H), (0, size(W) - W))
    o = zogy_oracle64(np.pad(new, pad), np.pad(ref, pad), pn, pr, SN, SR,
                      1.0, FR, vbn=np.pad(vbn.astype(np.float64), pad,
                                          mode="edge"),
                      vbr=np.pad(vbr.astype(np.float64), pad, mode="edge"))
    for k in ("Scorr", "D", "S"):
        w = o[k][:H, :W]
        jdev = np.abs(want[k] - w).max()
        pdev = np.abs(n(got[k]) - w).max()
        assert pdev <= 2.0 * jdev + 1e-6 * np.abs(w).max(), (k, pdev, jdev)


def test_zogy_auto_route():
    """"auto" takes the xla route off the card (and on small frames)."""
    args = _inputs(120, 120)
    auto = tz.zogy_subtract(*(t(a) for a in args[:4]), SN, SR,
                            params=tz.ZogyParams(fft="auto"))
    xla = tz.zogy_subtract(*(t(a) for a in args[:4]), SN, SR,
                           params=tz.ZogyParams(fft="xla"))
    before = kernels.launches["fft_cols_split"]
    for k in ("D", "Scorr"):
        assert_exact(auto[k], xla[k], k)
    assert kernels.launches["fft_cols_split"] == before


def test_otf_builders_match_jax():
    pn = _gauss_psf(25, 3.1)
    for shape in ((96, 160), (256, 384)):
        for full in (False, True):
            assert_close(tz.psf_to_otf(t(pn), shape, full=full),
                         jz.psf_to_otf(jnp.asarray(pn), shape, full=full),
                         rtol=0, atol=2e-6, what=f"psf_to_otf {full}")
        otf = tz.psf_to_otf(t(pn), shape)
        assert_close(tz.otf_to_psf_stamp(otf, shape, 25), pn, rtol=0,
                     atol=2e-6, what="stamp")
    shape = (256, 384)
    re_w, im_w = jz._otf_scr(jnp.asarray(pn), shape)
    re_g, im_g = tz._otf_scr(t(pn), shape)
    assert_close(re_g, re_w, rtol=0, atol=2e-6, what="otf_scr re")
    assert_close(im_g, im_w, rtol=0, atol=2e-6, what="otf_scr im")
    assert_close(tz._otf_scr_to_stamp(re_g, im_g, shape, 25), pn, rtol=0,
                 atol=2e-6, what="scr stamp")


def test_flux_ratio_matches_jax():
    rng = np.random.default_rng(2)
    N = 300
    fn_ = np.exp(rng.uniform(np.log(1e3), np.log(1e5), N)).astype(np.float32)
    fr_ = (fn_ / 1.3 * rng.normal(1.0, 0.02, N)).astype(np.float32)
    fr_[:5] *= 3.0                                   # outliers
    snr_n = (fn_ / 30.0).astype(np.float32)
    snr_r = (fr_ / 25.0).astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    want = jz.flux_ratio(*(jnp.asarray(a) for a in (fn_, fr_, snr_n, snr_r,
                                                    valid)))
    got = tz.flux_ratio(*(t(a) for a in (fn_, fr_, snr_n, snr_r, valid)))
    assert_close(got[0], want[0], rtol=1e-6, what="fratio")
    assert_close(got[1], want[1], rtol=1e-4, atol=1e-6, what="fratio_std")
    assert_exact(got[2], want[2], "nkeep")
    assert got[0].dtype == torch.float32
