"""Parity of the port's two-pass shift remap (ops/warp.py) with the JAX
package's, on a production-scale registration (0.05 deg rotation plus a
fractional offset) at a small frame.

Tolerances.  The nearest planes and every fill decision are exact: the
coordinate planes agree bit for bit (the same lerp or matmul of the
same nodes) and rounding them picks the same shift.  The Lanczos plane
is held at 2e-6 of the image's scale plus 2e-5 of each value: its
weights come from sin/cos, which XLA and PyTorch evaluate to within an
ulp or two of each other, and where a sample sits within ~1e-3 px of
a tap the weight is a ratio of two small numbers that amplifies that
ulp (measured: 9.4e-6 relative on 2 of 46400 pixels).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_close, assert_exact, t  # noqa: E402
from blackbox_tpu.ops import warp as jwarp  # noqa: E402
from blackbox_tpu_torch.ops import warp as twarp  # noqa: E402

H, W, STEP = 200, 232, 32


def _scene():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 100.0 + 5 * np.sin(yy / 17.0) + 4 * np.cos(xx / 23.0)
    for yc, xc in [(60, 70), (128, 128), (190, 40)]:
        img += 900.0 * np.exp(-((yy - yc) ** 2 + (xx - xc) ** 2) / 8.0)
    img = img.astype(np.float32)
    std = rng.uniform(1, 2, (H, W)).astype(np.float32)
    msk = (rng.uniform(size=(H, W)) < 0.05).astype(np.uint8)
    th = np.deg2rad(0.05)
    ct, st = np.cos(th), np.sin(th)
    cy, cx = H / 2, W / 2
    gy = np.arange(0, H + STEP, STEP, np.float64)
    gx = np.arange(0, W + STEP, STEP, np.float64)
    gyy, gxx = np.meshgrid(gy - cy, gx - cx, indexing="ij")
    sx = (cx + ct * gxx + st * gyy + 3.2).astype(np.float32)
    sy = (cy - st * gxx + ct * gyy - 2.7).astype(np.float32)
    return img, std, msk, sy, sx


def _weights(n_out, n_nodes):
    Wm = np.zeros((n_out, n_nodes), np.float32)
    f = np.arange(n_out, dtype=np.float64) / STEP
    i0 = np.minimum(f.astype(np.int64), n_nodes - 2)
    tt = (f - i0).astype(np.float32)
    Wm[np.arange(n_out), i0] = 1.0 - tt
    Wm[np.arange(n_out), i0 + 1] = tt
    return Wm


@pytest.mark.parametrize("form", ["step", "matmul", "planes"])
@pytest.mark.parametrize("blocks", [1, 4])
def test_warp_shift2pass_matches_jax(form, blocks):
    img, std, msk, sy, sx = _scene()
    ranges = jwarp.grid_shift_ranges(sy, sx, step=STEP, blocks=blocks)
    assert twarp.grid_shift_ranges(sy, sx, step=STEP, blocks=blocks) == ranges
    if form == "step":
        jgrid = (jnp.asarray(sy), jnp.asarray(sx), STEP)
        tgrid = (t(sy), t(sx), STEP)
    else:
        wy, wx = _weights(H, sy.shape[0]), _weights(W, sy.shape[1])
        if form == "matmul":
            jgrid = tuple(jnp.asarray(a) for a in (sy, sx, wy, wx))
            tgrid = tuple(t(a) for a in (sy, sx, wy, wx))
        else:
            ys = np.asarray(jwarp.upsample_grid(jnp.asarray(sy),
                                                jnp.asarray(wy),
                                                jnp.asarray(wx)))
            xs = np.asarray(jwarp.upsample_grid(jnp.asarray(sx),
                                                jnp.asarray(wy),
                                                jnp.asarray(wx)))
            jgrid = (jnp.asarray(ys), jnp.asarray(xs))
            tgrid = (t(ys), t(xs))
    modes = ("lanczos", "nearest", "nearest")
    want = jwarp.warp_shift2pass(
        tuple(jnp.asarray(a) for a in (img, std, msk)), modes,
        (0.0, 1.5, np.uint8(32)), jgrid, ranges)
    got = twarp.warp_shift2pass(tuple(t(a) for a in (img, std, msk)), modes,
                                (0.0, 1.5, 32), tgrid, ranges)
    w_img = np.asarray(want[0])
    assert (w_img == 0.0).any()                   # some pixels take the fill
    assert_exact(got[0] == 0.0, w_img == 0.0, "fill")
    assert_close(got[0], w_img, rtol=2e-5,
                 atol=2e-6 * float(np.abs(img).max()), what="lanczos")
    assert_exact(got[1], want[1], "nearest f32")
    assert_exact(got[2], want[2], "nearest uint8")


def test_upsample_matches_jax():
    _, _, _, sy, sx = _scene()
    wy, wx = _weights(H, sy.shape[0]), _weights(W, sy.shape[1])
    assert_exact(twarp.upsample_lerp(t(sy), STEP, H, W),
                 jwarp.upsample_lerp(jnp.asarray(sy), STEP, H, W), "lerp")
    assert_close(twarp.upsample_grid(t(sx), t(wy), t(wx)),
                 jwarp.upsample_grid(jnp.asarray(sx), jnp.asarray(wy),
                                     jnp.asarray(wx)),
                 rtol=1e-6, what="matmul")
    assert twarp.grid_row_margin(sy, STEP) == jwarp.grid_row_margin(sy, STEP)
