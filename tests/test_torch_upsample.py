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
