"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

The suite runs under several pytest-xdist workers on one host, so
torch is pinned to one thread here, once, for every worker that
imports it.  Inputs are numpy arrays made from a seed and handed to
both packages; outputs come back as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

# K7's "overflow" predicate frame: on a sky of 100 with read noise 0,
# where gt(sp, sigclip) is +0 at the patch's (3, 2) pixel, m3 = 1e37 over
# a noise of sqrt(1e-5) makes f = +inf beside sp = -inf, so c1 is NaN
# there and only the 7x7 window test of m3 keeps the 7x7 median
K7_OVERFLOW_PATCH = np.array(
    [[1e2, 1e2, -1.7e38, 1e2, -1e37, 1e2, 1e2],
     [1.7e38, -1e37, -1.7e38, -1.7e38, -1e37, 1e2, 1e2],
     [-1e37, -1.7e38, 1e37, 0.0, 1e2, -1.7e38, -1e37],
     [1e2, 1.7e38, 0.0, 0.0, -1e37, 0.0, 0.0],
     [1e2, 1.7e38, 1e37, 1.7e38, -1e37, 1e2, 1e2],
     [1.7e38, -1.7e38, 1.7e38, 0.0, 1.7e38, 1e2, 1e2]], np.float32)


def t(a) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor (a copy: jax arrays are
    read-only)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """Tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_exact(got, want, what: str = ""):
    """Bit-for-bit equality (NaN equal to NaN), dtypes included."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_close(got, want, rtol: float, atol: float = 0.0, what: str = ""):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def jax_ctx(**overrides):
    """The JAX pipeline test context (tests/test_pipeline.py::_ctx),
    with the PSF stages off unless ``fit_psf=True`` is passed."""
    from test_pipeline import _ctx
    return dataclasses.replace(_ctx(), **{"fit_psf": False, **overrides})


def tiny_frame(seed: int):
    """A TINY raw science frame from the JAX package's host generator,
    plus masters and a crosstalk matrix, all numpy.

    Returns (chan, os_vert, os_hori, mbias, mflat, xtalk, truth).
    """
    from blackbox_tpu.core.geometry import TINY
    from blackbox_tpu.synth import make_raw_science
    rng = np.random.default_rng(seed)
    raw, truth = make_raw_science(TINY, rng, nstars=40, ncosmics=12,
                                  trail=True, nsat=2, sky_e=300.0)
    C = TINY.n_chan
    chan, osv, osh = (np.ascontiguousarray(a) for a in TINY.split_raw(raw))
    mflat = np.ascontiguousarray(TINY.disassemble(truth.flat),
                                 dtype=np.float32)
    mbias = (0.5 * rng.standard_normal(TINY.chan_shape)).astype(np.float32)
    xtalk = rng.uniform(-2e-4, 2e-4, (C, C)).astype(np.float32)
    return chan, osv, osh, mbias, mflat, xtalk, truth


def cosmic_scene(seed: int, H: int, W: int, ncr: int, nstars: int = 0):
    """A float32 e- scene for the L.A.Cosmic tests: Poisson sky (300
    e-), Gaussian stars (sigma 1.5 px) and 1-2 px cosmic hits."""
    rng = np.random.default_rng(seed)
    img = rng.poisson(300.0, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    for _ in range(nstars):
        y, x = rng.uniform(5, H - 5), rng.uniform(5, W - 5)
        img += (rng.uniform(2e3, 4e4) / (2 * np.pi * 1.5 ** 2) * np.exp(
            -((yy - y) ** 2 + (xx - x) ** 2) / (2 * 1.5 ** 2))).astype(
                np.float32)
    cy = rng.integers(3, H - 3, ncr)
    cx = rng.integers(3, W - 3, ncr)
    for x, y, a in zip(cx, cy, rng.uniform(3000, 30000, ncr)):
        img[y, x] += a
        if a > 15000:
            img[y, x + 1] += 0.6 * a
    return img
