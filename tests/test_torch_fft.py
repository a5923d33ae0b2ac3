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


def test_dft_constants_header_is_generated():
    """csrc/fft_constants.cuh is dft_constants_source() verbatim."""
    import pathlib
    path = (pathlib.Path(tfft.__file__).resolve().parents[1] / "csrc"
            / "fft_constants.cuh")
    assert path.read_text() == tfft.dft_constants_source()


@pytest.mark.parametrize("N", [96, 160, 224, 352, 168, 10752])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_constants_equal_tables(N, inverse):
    """The literals the kernel compiles in are the f32 rounding of
    _tables' DFT_N2 constants for every size, bit for bit, and the
    JAX package's tables round the same float64 values."""
    import re
    N1, N2, k = tfft.plan(N)
    src = tfft.dft_constants_source()
    name = f"kDft{N2}{'Inv' if inverse else 'Fwd'}"
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    lits = np.array([float.fromhex(v.strip().rstrip("f"))
                     for v in body.split(",") if v.strip()], np.float32)
    w21 = tfft._tables(N, inverse)[4]
    want = np.stack([w21.real, w21.imag], -1).astype(np.float32)
    assert lits.view(np.uint32).tolist() == \
        want.reshape(-1).view(np.uint32).tolist()
    jw = jfft._tables(N, inverse)[4]
    assert np.array_equal(np.stack([jw.real, jw.imag], -1).astype(
        np.float32).view(np.uint32), want.view(np.uint32))


def _dft_paired(xs, N2, inverse):
    """The kernel's DFT_N2 (csrc/fft.cu dft_first / dft_pair): output 0
    term by term, then outputs j and N2 - j together, sharing a term or
    its products where dft_pair_masks allows."""
    c = tfft.dft_constants(N2, inverse)
    masks = tfft.dft_pair_masks(N2, inverse)
    W = (lambda n, r: c[r][n]) if inverse else (lambda n, r: c[n][r])

    def term(w, x):
        wr, wi = (torch.tensor(v) for v in w)
        return wr * x[0] - wi * x[1], wr * x[1] + wi * x[0]

    def add(acc, t):
        return t if acc is None else (acc[0] + t[0], acc[1] + t[1])

    out = [None] * N2
    for n, x in enumerate(xs):
        out[0] = add(out[0], term(W(n, 0), x))
        for j in range(1, N2 // 2 + 1):
            t = term(W(n, j), x)
            if masks[n] >> j & 1:
                wr, wi = (torch.tensor(v) for v in W(n, j))
                p1, p2, p3, p4 = wr * x[0], wi * x[1], wr * x[1], wi * x[0]
                t, u = (p1 - p2, p3 + p4), (p1 + p2, p3 - p4)
            elif masks[n] >> (16 + j) & 1:
                u = t
            else:
                u = term(W(n, N2 - j), x)
            out[j] = add(out[j], t)
            out[N2 - j] = add(out[N2 - j], u)
    return out


@pytest.mark.parametrize("N2", [3, 5, 7, 11, 21])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_pairs_keep_every_rounding(N2, inverse):
    """The kernel's shared products (dft_pair_masks) give the plain
    DFT_N2's bits: on random values, signed zeros, infinities, NaN and
    values near the float32 limits."""
    rng = np.random.default_rng(N2 + 100 * inverse)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3e38, -1e-45],
                       np.float32)
    xs = []
    for _ in range(N2):
        v = rng.standard_normal((2, 4096)).astype(np.float32)
        v[:, :len(special)] = special
        v[:, 7:64] = rng.choice(special, (2, 57))
        xs.append(v)
    # columns with one nonzero part of one input: there the tiny
    # imaginary parts of the near-real constants reach the sums
    for c in range(256, 1024):
        for n, v in enumerate(xs):
            v[:, c] = 0.0
            if n == c % N2:
                v[c % 2, c] = rng.standard_normal()
    xs = [(t(v[0]), t(v[1])) for v in xs]
    w = tfft.dft_constants(N2, inverse).tolist()
    want = tfft._dft_n2(xs, w, inverse)
    got = _dft_paired(xs, N2, inverse)
    for g, e in zip(got, want):
        for a, b in zip(g, e):
            same = (a.view(torch.int32) == b.view(torch.int32)) | (
                torch.isnan(a) & torch.isnan(b))
            assert bool(same.all())
