"""The JAX package's public helpers against their port counterparts, on
the CPU: the same numpy inputs from a seed through both.

Ints, bools and counts are held bit for bit (and the morphology also
against ``scipy.ndimage`` with the border rules the JAX docstrings
state: dilation pads False, erosion pads True); floats at rtol 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import assert_close, assert_exact, t  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from blackbox_tpu.core import maskbits as JB  # noqa: E402
from blackbox_tpu.ops import labeling as JL  # noqa: E402
from blackbox_tpu.ops import masking as JK  # noqa: E402
from blackbox_tpu.ops import morphology as JM  # noqa: E402
from blackbox_tpu.ops import photometry as JP  # noqa: E402
from blackbox_tpu.ops import stats as JS  # noqa: E402
from blackbox_tpu.ops import xtalk as JX  # noqa: E402
from blackbox_tpu_torch.core import maskbits as TB  # noqa: E402
from blackbox_tpu_torch.ops import labeling as TL  # noqa: E402
from blackbox_tpu_torch.ops import masking as TK  # noqa: E402
from blackbox_tpu_torch.ops import morphology as TM  # noqa: E402
from blackbox_tpu_torch.ops import photometry as TP  # noqa: E402
from blackbox_tpu_torch.ops import stats as TS  # noqa: E402
from blackbox_tpu_torch.ops import xtalk as TX  # noqa: E402


def _mask(seed, shape=(37, 45), frac=0.3):
    return np.random.default_rng(seed).random(shape) < frac


# ------------------------------------------------------------- labeling

@pytest.mark.parametrize("seed, frac, iters", [(0, 0.1, 64), (1, 0.25, 64),
                                               (2, 0.35, 64), (3, 0.5, 4)])
def test_count_components(seed, frac, iters):
    """The port's count against JAX's (both bounded by ``iters``) and,
    where the steps reach across every component, against scipy's."""
    m = _mask(seed, frac=frac)
    got = TL.count_components(t(m), iters=iters)
    want = JL.count_components(jnp.asarray(m), iters=iters)
    assert got.dtype == torch.int64
    assert int(got) == int(want)
    host = TL.count_components_host(t(m))
    assert host == JL.count_components_host(m) == TL.count_components_host(m)
    if iters == 64:
        assert int(got) == host
    else:
        assert int(got) >= host


def test_count_components_long_snake():
    """A 1-pixel serpentine of ~700 pixels: one component for scipy, more
    for a labeling of 16 steps, the same number in both packages."""
    m = np.zeros((40, 40), bool)
    m[::4, 1:-1] = True
    m[1::8, -2] = m[2::8, -2] = m[3::8, -2] = True
    m[5::8, 1] = m[6::8, 1] = m[7::8, 1] = True
    m = m[:37]
    assert TL.count_components_host(t(m)) == 1
    got = int(TL.count_components(t(m), iters=16))
    assert got == int(JL.count_components(jnp.asarray(m), iters=16)) > 1


# ---------------------------------------------------------- masks, xtalk

@pytest.mark.parametrize("seed", [0, 1])
def test_mask_counts(seed):
    m = np.random.default_rng(seed).integers(0, 128, (33, 41)).astype(
        np.int32)
    got = TK.mask_counts(t(m))
    want = JK.mask_counts(jnp.asarray(m))
    assert list(got) == list(want)
    for k in want:
        assert int(got[k]) == int(want[k]), k


def test_header_keys():
    assert list(TB.HEADER_KEYS.items()) == list(JB.HEADER_KEYS.items())
    assert set(TB.HEADER_KEYS) <= set(TB.BITS)


@pytest.mark.parametrize("nx", [8, 4, 16])
def test_coeff_quadrants(nx):
    c = np.random.default_rng(nx).uniform(-2e-4, 2e-4, (16, 16)).astype(
        np.float32)
    same, cross = TX.coeff_quadrants(t(c), nx)
    wsame, wcross = JX.coeff_quadrants(c, nx)
    assert_exact(same, np.asarray(wsame, np.float32), "same row")
    assert_exact(cross, np.asarray(wcross, np.float32), "cross row")
    assert torch.equal(same + cross, t(c))


# ------------------------------------------------------------ morphology

def _scipy(op, m, iterations, size):
    st = np.ones((size, size), bool)
    if op == "dilation":
        return ndimage.binary_dilation(m, st, iterations=iterations)
    return ndimage.binary_erosion(m, st, iterations=iterations,
                                  border_value=1)


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("op", ["dilation", "erosion"])
def test_dilation_erosion(op, size, iterations):
    m = _mask(size * 10 + iterations, frac=0.3 if op == "dilation" else 0.8)
    got = getattr(TM, f"binary_{op}")(t(m), iterations=iterations,
                                      size=size)
    want = getattr(JM, f"binary_{op}")(jnp.asarray(m),
                                       iterations=iterations, size=size)
    assert_exact(got, np.asarray(want))
    assert_exact(got, _scipy(op, m, iterations, size))


@pytest.mark.parametrize("size", [3, 5])
def test_closing(size):
    """JAX's closing erodes with outside True (scipy's closing erodes
    with outside False, so scipy is composed here)."""
    m = _mask(size, frac=0.4)
    got = TM.binary_closing(t(m), size=size)
    assert_exact(got, np.asarray(JM.binary_closing(jnp.asarray(m),
                                                   size=size)))
    st = np.ones((size, size), bool)
    assert_exact(got, ndimage.binary_erosion(
        ndimage.binary_dilation(m, st), st, border_value=1))


def test_even_size_grows_the_plane():
    """An even size pads size // 2 on each side, as the JAX package's
    window reduction does: the output grows by one a side pair."""
    m = _mask(7, shape=(20, 24))
    got = TM.binary_dilation(t(m), size=4)
    want = np.asarray(JM.binary_dilation(jnp.asarray(m), size=4))
    assert got.shape == (21, 25)
    assert_exact(got, want)


def test_fill_holes_takes_size():
    m = np.zeros((24, 30), bool)
    m[4:12, 5:15] = True
    m[6:9, 8:11] = False
    got = TM.fill_holes(t(m), size=5)
    assert_exact(got, TM.fill_holes(t(m)))
    assert_exact(got, np.asarray(JM.fill_holes(jnp.asarray(m), size=5)))
    assert bool(got[7, 9]) and not bool(t(m)[7, 9])


# ------------------------------------------------------------ statistics

def _outliers(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 5.0, shape).astype(np.float32)
    hit = rng.random(shape) < 0.05
    x[hit] += rng.uniform(50, 500, int(hit.sum())).astype(np.float32)
    x[rng.random(shape) < 0.01] = np.nan
    return x


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("masked", [False, True])
def test_sigma_clipped_median(masked, axis):
    x = _outliers(3, (12, 301))
    mask = (np.random.default_rng(4).random(x.shape) < 0.2) if masked \
        else None
    got = TS.sigma_clipped_median(t(x), None if mask is None else t(mask),
                                  axis=axis)
    want = JS.sigma_clipped_median(jnp.asarray(x), None if mask is None
                                   else jnp.asarray(mask), axis=axis)
    assert_close(got, np.asarray(want), rtol=1e-5)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("cenfunc", ["mean", "median"])
def test_sigma_clipped_median_cenfunc(cenfunc):
    x = _outliers(5, (6, 257))
    got = TS.sigma_clipped_median(t(x), cenfunc=cenfunc, iters=3,
                                  sigma=2.5)
    want = JS.sigma_clipped_median(jnp.asarray(x), cenfunc=cenfunc, iters=3,
                                   sigma=2.5)
    assert_close(got, np.asarray(want), rtol=1e-5)


def test_snr_optimal():
    rng = np.random.default_rng(6)
    flux = rng.normal(0, 1e3, 200).astype(np.float32)
    err = rng.uniform(0, 50, 200).astype(np.float32)
    err[:5] = 0.0
    err[5:8] = -1.0
    err[8] = np.nan
    got = TP.snr_optimal(t(flux), t(err))
    assert_close(got, np.asarray(JP.snr_optimal(jnp.asarray(flux),
                                                jnp.asarray(err))),
                 rtol=1e-5)
