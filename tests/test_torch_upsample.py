"""K3, the background-mesh upsample: the port's plain version
(``ops/upsample``) against the JAX package's Pallas kernel in interpret
mode and against its default matmul ``mini2back``, at the shapes of
tests/test_pallas_upsample.py.

Tolerance: atol 1e-3 e- on a 200 e- mesh (tests/test_pallas_upsample.py's
own bar): the same weights and the same two contractions, summed in
another float32 order.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_close, t  # noqa: E402
from blackbox_tpu.ops.background import _catmull_rom_matrix  # noqa: E402
from blackbox_tpu.ops.background import mini2back as jmini2back  # noqa: E402
from blackbox_tpu.pallas.upsample import upsample_mesh_pallas  # noqa: E402
from blackbox_tpu_torch.ops import background, upsample  # noqa: E402

CASES = [((1024, 1024), 128, 1), ((520, 650), 130, 2)]


@pytest.mark.parametrize("shape, box, nmesh", CASES)
def test_upsample_matches_pallas(shape, box, nmesh):
    H, W = shape
    ny, nx = H // box, W // box
    rng = np.random.default_rng(H + nmesh)
    meshes = [(200.0 + 5.0 * rng.standard_normal((ny, nx))).astype(
        np.float32) for _ in range(nmesh)]
    Wy = _catmull_rom_matrix(H, ny, box)
    Wx = _catmull_rom_matrix(W, nx, box)
    want = upsample_mesh_pallas(tuple(jnp.asarray(m) for m in meshes), Wy,
                                Wx, (H, W), interpret=True)
    got = upsample.upsample_mesh(tuple(t(m) for m in meshes), Wy, Wx, (H, W))
    assert len(got) == nmesh
    for g, w in zip(got, want):
        assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape, box, nmesh", CASES)
def test_mini2back_use_pallas_matches_jax(shape, box, nmesh):
    """``mini2back(use_pallas=True)`` (K3's plain version) and the
    default matmul pair, both against the JAX package's default."""
    H, W = shape
    rng = np.random.default_rng(box)
    mesh = (200.0 + 5.0 * rng.standard_normal((H // box, W // box))).astype(
        np.float32)
    want = np.asarray(jmini2back(jnp.asarray(mesh), (H, W), box))
    for use_pallas in (True, False):
        got = background.mini2back(t(mesh), (H, W), box,
                                   use_pallas=use_pallas)
        assert_close(got, want, rtol=0, atol=1e-3)


def test_plain_version_order_of_sums():
    """The plain version is the kernel's sum order: ascending index,
    one rounded product and one rounded add a term (so the card's
    kernel can be held to it bit for bit)."""
    rng = np.random.default_rng(0)
    mesh = rng.standard_normal((3, 4)).astype(np.float32)
    Wy = rng.standard_normal((5, 3)).astype(np.float32)
    Wx = rng.standard_normal((6, 4)).astype(np.float32)
    up = np.zeros((5, 4), np.float32)
    for i in range(3):
        up = up + (Wy[:, i, None] * mesh[i][None, :]).astype(np.float32)
    want = np.zeros((5, 6), np.float32)
    for j in range(4):
        want = want + (up[:, j, None] * Wx[None, :, j]).astype(np.float32)
    got = upsample._upsample_plain((t(mesh),), Wy, Wx, (5, 6))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("n_out, n_mesh, box", [
    (132, 4, 33), (320, 9, 33),          # TINY at its 33-px box
    (10560, 41, 256),                    # MeerLICHT at 256 px
])
def test_weight_bands_of_catmull_rom(n_out, n_mesh, box):
    """The kernel's band rule on the Catmull-Rom weights: at most 4
    entries a row, every nonzero entry inside its row's band."""
    w = t(_catmull_rom_matrix(n_out, n_mesh, box))
    b = upsample.weight_bands(w).numpy()
    width = b[:, 1] - b[:, 0] + 1
    assert width.min() >= 1 and width.max() <= 4, (width.min(), width.max())
    idx = np.arange(n_mesh)
    outside = (idx < b[:, :1]) | (idx > b[:, 1:])
    assert not (w.numpy()[outside] != 0).any()


def _banded_reference(mesh, Wy, Wx, full_range=True):
    """The kernel's sums, written out: each product summed over its
    row's band of nonzero weights, ascending, one rounded multiply and
    add a term; with ``full_range``, over the full range where the
    other factor is not all finite (the mesh for the first product, the
    row of Wy @ mesh for the second)."""
    def bands(w, full):
        b = upsample.weight_bands(t(w)).numpy()
        return [(0, w.shape[1] - 1) if f else (lo, hi)
                for (lo, hi), f in zip(b, full)]

    H, W = Wy.shape[0], Wx.shape[0]
    full = full_range and not np.isfinite(mesh).all()
    up = np.zeros((H, mesh.shape[1]), np.float32)
    for y, (lo, hi) in enumerate(bands(Wy, [full] * H)):
        for i in range(lo, hi + 1):
            up[y] = up[y] + Wy[y, i] * mesh[i]
    out = np.zeros((H, W), np.float32)
    row_full = ~np.isfinite(up).all(1) & full_range
    for x, (lo, hi) in enumerate(bands(Wx, [False] * W)):
        col = np.zeros(H, np.float32)
        for j in range(mesh.shape[1]):
            take = row_full | (lo <= j <= hi)
            col = np.where(take, col + up[:, j] * Wx[x, j], col)
        out[:, x] = col
    return out


@pytest.mark.parametrize("case", ["finite", "inf", "nan"])
def test_band_limited_sum_is_the_dense_sum(case):
    """The band-limited ascending sum equals the plain (dense) version
    bit for bit, up to the sign of a zero: on a finite mesh, and on a
    mesh with one inf or NaN, where the sums take the full range and
    give NaN exactly where the dense sum has it (0 * inf)."""
    H, W, box = 160, 96, 32
    rng = np.random.default_rng(5)
    mesh = (200.0 + 5.0 * rng.standard_normal((H // box, W // box))).astype(
        np.float32)
    mesh[1, 2] = {"finite": mesh[1, 2], "inf": np.inf, "nan": np.nan}[case]
    Wy = _catmull_rom_matrix(H, H // box, box)
    Wx = _catmull_rom_matrix(W, W // box, box)
    want = upsample._upsample_plain((t(mesh),), Wy, Wx, (H, W))[0].numpy()
    got = _banded_reference(mesh, Wy, Wx)
    np.testing.assert_array_equal(got, want)     # NaN == NaN, -0 == +0
    if case == "finite":
        assert np.isfinite(want).all()
    else:
        # every output has a 0 * inf, 0 * NaN or w * inf term, far
        # outside the bad node's 4-node reach, which the band alone
        # would skip
        assert not np.isfinite(want).any()
        assert np.isfinite(_banded_reference(mesh, Wy, Wx, False)).any()
