"""Parity of the port's split-real FFT (ops/fft.py) with the JAX package's
Pallas kernel (pallas/fft.py, run in interpret mode on the CPU as its own
tests run it), and of the 2-D wrappers with a numpy DFT.

On the CPU the port's ``fft_cols_split`` is the kernel's plain version:
the same plan, the same float64-built f32 tables and the same operation
order on whole planes.  It is held to the Pallas kernel at 2 float32
ulps of the spectrum's largest value (4e-7 of it; measured 1.3e-7 to
1.9e-7, with a third to a half of the values bit-equal): the two run
the same arithmetic, but XLA's CPU backend may contract a multiply and
an add of the twiddle products into one fused operation where PyTorch
rounds each.  The 2-D transform is held to ``numpy.fft.fft2`` at 3e-6 of its
scale, the JAX package's own bound (tests/test_pallas_fft.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import n, t  # noqa: E402
from blackbox_tpu.pallas import fft as jfft  # noqa: E402
from blackbox_tpu_torch.ops import fft as tfft  # noqa: E402

ULPS = 4e-7     # two float32 ulps, relative to the largest magnitude


@pytest.mark.parametrize("N", [96, 160, 352, 384])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_cols_matches_pallas(N, inverse):
    rng = np.random.default_rng(N + inverse)
    xr = rng.standard_normal((N, 128)).astype(np.float32)
    xi = rng.standard_normal((N, 128)).astype(np.float32)
    scale = 1.0 / N if inverse else 1.0
    want = jfft.fft_cols_split(jnp.asarray(xr), jnp.asarray(xi),
                               inverse=inverse, scale=scale, interpret=True)
    before = tfft.fft_cols_split.launches
    got = tfft.fft_cols_split(t(xr), t(xi), inverse, scale)
    assert tfft.fft_cols_split.launches == before     # plain on the CPU
    big = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=0,
                                   atol=ULPS * big)


@pytest.mark.parametrize("N", [96, 384])
def test_fft_cols_is_the_scrambled_dft(N):
    rng = np.random.default_rng(N)
    xr = rng.standard_normal((N, 40)).astype(np.float32)
    xi = rng.standard_normal((N, 40)).astype(np.float32)
    yr, yi = tfft.fft_cols_split(t(xr), t(xi))
    got = (n(yr) + 1j * n(yi))[tfft.spectrum_perm(N)]
    want = np.fft.fft(xr + 1j * xi, axis=0)
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-6
    zr, zi = tfft.fft_cols_split(yr, yi, inverse=True, scale=1.0 / N)
    assert np.abs(n(zr) - xr).max() < 1e-5
    assert np.abs(n(zi) - xi).max() < 1e-5


def test_fft2_split_matches_pallas():
    H, W = 256, 384
    rng = np.random.default_rng(0)
    xr = rng.standard_normal((H, W)).astype(np.float32)
    xi = rng.standard_normal((H, W)).astype(np.float32)
    want = jfft.fft2_split(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    got = tfft.fft2_split(t(xr), t(xi))
    assert got[0].shape == (W, H)
    big = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=0,
                                   atol=ULPS * big)

    z = n(tfft.unscramble2(*got))
    ref = np.fft.fft2(xr + 1j * xi)
    assert np.abs(z - ref).max() / np.abs(ref).max() < 3e-6

    back = tfft.ifft2_split(*got)
    jback = jfft.ifft2_split(*want, interpret=True)
    # the inverse starts from spectra that already differ by rounding;
    # each output averages H·W of those differences: 1e-6 of its scale
    for g, w, x in zip(back, jback, (xr, xi)):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=0,
                                   atol=1e-6 * float(np.abs(x).max()))
        assert np.abs(n(g) - x).max() < 2e-5


def test_fft_cols_refuses_bad_input():
    with pytest.raises(ValueError, match="unsupported FFT size"):
        tfft.fft_cols_split(torch.zeros(84, 4), torch.zeros(84, 4))
    with pytest.raises(ValueError, match="shape"):
        tfft.fft_cols_split(torch.zeros(96, 4), torch.zeros(96, 5))
    with pytest.raises(TypeError, match="float32"):
        tfft.fft_cols_split(torch.zeros(96, 4, dtype=torch.float64),
                            torch.zeros(96, 4, dtype=torch.float64))
