"""Parity of the port's median filters and stencils (kernel K2's plain
version) with the JAX package: exact, against the jnp strip path and the
Pallas kernel in interpret mode (blackbox_tpu/pallas/medians.py)."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_exact, t  # noqa: E402
from blackbox_tpu.ops import filters as jf  # noqa: E402
from blackbox_tpu_torch.ops import filters as tf  # noqa: E402


def _image(rng, H, W):
    img = rng.normal(100.0, 20.0, (H, W)).astype(np.float32)
    img[10, 40] = 1e6            # outliers exercise the rank selection
    img[30, 250 % W] = -1e6
    img[1, 2] = 1e30
    return img


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_filter_matches_jnp_and_pallas(k, rng):
    from blackbox_tpu.pallas.medians import median_filter_pallas
    img = _image(rng, 48, 300)
    img[20, 100] = np.nan        # NaN propagates through min/max alike
    got = tf.median_filter(t(img), k, strip_rows=13)
    assert_exact(got, jf.median_filter(jnp.asarray(img), k, strip_rows=16))
    img[20, 100] = 7.0           # interpret mode, many tiles and borders
    want = median_filter_pallas(jnp.asarray(img), k, th=16, tw=128,
                                interpret=True)
    assert_exact(tf.median_filter(t(img), k), want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_filter_small_frames(k, rng):
    """Frames narrower than the window: every pixel is border."""
    for H, W in ((k - 1, 9), (k, k), (k + 1, 2 * k)):
        img = rng.normal(size=(H, W)).astype(np.float32)
        assert_exact(tf.median_filter(t(img), k),
                     jf.median_filter(jnp.asarray(img), k, strip_rows=8))


def test_masked_median_filter_matches_jnp(rng):
    img = _image(rng, 60, 90)
    bad = rng.random(img.shape) > 0.6
    bad[20:30, 20:30] = True                 # windows with no good pixel
    fb = rng.normal(size=img.shape).astype(np.float32)
    want = jf.masked_median_filter(jnp.asarray(img), jnp.asarray(bad), 5,
                                   strip_rows=16, fallback=jnp.asarray(fb))
    got = tf.masked_median_filter(t(img), t(bad), 5, strip_rows=7,
                                  fallback=t(fb))
    assert_exact(got, want)
    assert_exact(tf.masked_median_filter(t(img), t(bad), 5),
                 jf.masked_median_filter(jnp.asarray(img), jnp.asarray(bad)))


def test_laplacian_and_dilate_match_jnp(rng):
    img = _image(rng, 40, 64)
    assert_exact(tf.laplacian_subsampled(t(img)),
                 jf.laplacian_subsampled(jnp.asarray(img)))
    m = rng.random((40, 64)) > 0.9
    m[0, 0] = m[-1, -1] = True
    for k in (3, 5):
        assert_exact(tf.dilate(t(m), k), jf.dilate(jnp.asarray(m), k))


def test_network_header_is_generated():
    """csrc/median_networks.cuh is median_network_source() verbatim
    (regenerate it from that function after a network change)."""
    import blackbox_tpu_torch
    path = os.path.join(os.path.dirname(blackbox_tpu_torch.__file__),
                        "csrc", "median_networks.cuh")
    with open(path) as f:
        assert f.read() == tf.median_network_source()


def test_kernel_wrapper_never_falls_back():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError, match="median_filter"):
        tf.median_filter(img, 5)


def _patches(k, case, n=3000, seed=0):
    """n random (k+th-1) x (k+tw-1) patches of the kernel's tile, as a
    (rows, cols, n) tensor: normal values, few-valued ties, constant
    plateaus, or normal values with +-inf or NaN sprinkled in."""
    th, tw = tf.MEDIAN_TILE
    shape = (k + th - 1, k + tw - 1, n)
    g = torch.Generator().manual_seed(seed + k)
    p = torch.randn(shape, generator=g)
    if case == "ties":
        p = torch.randint(0, 3, shape, generator=g).float()
    elif case == "plateau":
        p[..., : n // 2] = 7.0
        p[: k // 2 + 1, :, n // 2:] = -2.0        # a plateau over half a window
    elif case in ("inf", "nan"):
        hit = torch.rand(shape, generator=g) < 0.01
        sign = torch.where(torch.rand(shape, generator=g) < 0.5, -1.0, 1.0)
        p = torch.where(hit, sign * float("inf") if case == "inf"
                        else torch.full(shape, float("nan")), p)
        if case == "inf":
            p[..., :100] = float("inf")          # windows of +inf only
    return p


@pytest.mark.parametrize("case", ["normal", "ties", "plateau", "inf", "nan"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_tile_program_is_a_median(k, case):
    """The CUDA kernel's tile program (tile_median_ops), run through
    apply_ops on CPU tensors of patches, gives each window's
    k*k//2-th order statistic (torch.sort's), and NaN exactly where the
    window holds a NaN."""
    th, tw = tf.MEDIAN_TILE
    p = _patches(k, case)
    ops, outs, _ = tf.tile_median_ops(k, th, tw)
    v = tf.apply_ops([p[y, x] for y in range(p.shape[0])
                      for x in range(p.shape[1])], ops)
    for i, wire in enumerate(outs):
        r, c = divmod(i, tw)
        win = p[r:r + k, c:c + k].reshape(k * k, -1)
        has_nan = torch.isnan(win).any(0)
        want = torch.sort(win, 0).values[k * k // 2]
        got = v[wire]
        assert torch.equal(torch.isnan(got), has_nan), (r, c)
        assert torch.equal(got[~has_nan], want[~has_nan]), (r, c)
    if case == "nan":
        assert bool(has_nan.any())


@pytest.mark.parametrize("k", [3, 5, 7])
def test_tile_program_costs_less(k):
    """Fewer min/max a pixel than the sorted-column design it replaced
    on the card (a column sort a pixel plus the pruned merge), and the
    header states the program's count."""
    th, tw = tf.MEDIAN_TILE
    ops, _, _ = tf.tile_median_ops(k, th, tw)
    merge, _ = tf.sc_select_ops(k, (k * k // 2,))
    old = 2 * len(tf.transposition_pairs(k)) + tf.comparator_cost(merge)
    assert tf.comparator_cost(ops) / (th * tw) < old
    assert (f"// {tf.comparator_cost(ops)} min/max for {th * tw} outputs"
            in tf.median_network_source())
