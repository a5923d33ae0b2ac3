"""Parity of the port's labeling (kernel K1's plain version) with the
JAX package: exact integers, against the jnp pool path and the Pallas
kernel in interpret mode (blackbox_tpu/pallas/labelprop.py)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_exact, t  # noqa: E402
from blackbox_tpu.ops import labeling as jl  # noqa: E402
from blackbox_tpu_torch.ops import labeling as tl  # noqa: E402


def _blobby_mask(rng, H, W, nblobs=120):
    m = np.zeros((H, W), bool)
    ys = rng.integers(0, H, nblobs)
    xs = rng.integers(0, W, nblobs)
    for y, x in zip(ys, xs):
        ry, rx = rng.integers(1, 9, 2)
        m[max(0, y - ry):y + ry, max(0, x - rx):x + rx] = True
    # a long diagonal structure: wider than any label bound, so it splits
    for i in range(0, min(H, W) - 2):
        m[i, i] = m[i, i + 1] = True
    return m


@pytest.mark.parametrize("iters", [1, 24, 32, 40])
def test_label_components_matches_jnp(rng, iters):
    mask = _blobby_mask(rng, 150, 230)
    mask[0, :] = True          # components touching the frame border
    mask[:, -1] = True
    want = jl.label_components(jnp.asarray(mask), iters=iters,
                               use_pallas=False)
    assert_exact(tl.label_components(t(mask), iters=iters), want)


def test_label_propagate_matches_pallas_interpret(rng):
    """Components spanning the Pallas kernel's 512-tile seams."""
    from blackbox_tpu.pallas.labelprop import label_propagate_pallas
    H, W = 1040, 560
    mask = np.zeros((H, W), bool)
    mask[500:525, 40:45] = True          # crosses the row-512 seam
    mask[100:104, 490:530] = True        # crosses the col-512 seam
    mask |= _blobby_mask(rng, H, W, nblobs=40)
    idx = np.arange(1, H * W + 1, dtype=np.int32).reshape(H, W)
    lab0 = np.where(mask, idx, np.int32(H * W + 2))
    want = label_propagate_pallas(jnp.asarray(lab0), iters=32,
                                  interpret=True)
    assert_exact(tl.label_propagate(t(lab0), 32), want)


def test_euler_count_matches_jnp(rng):
    for frac in (0.05, 0.3, 0.6):
        m = rng.random((97, 130)) < frac
        m[0, 5:9] = True                 # blobs on the border count
        m[-1, -3:] = True
        assert_exact(tl.euler_count(t(m)), jl.euler_count(jnp.asarray(m)))
    ring = np.zeros((20, 20), bool)      # a hole: Euler number 0
    ring[5:10, 5:10] = True
    ring[7, 7] = False
    assert int(tl.euler_count(t(ring))) == 0


def test_kernel_wrapper_never_falls_back():
    """A non-CPU tensor goes to the kernel path, which refuses a tensor
    that is not on a CUDA device instead of running the plain version."""
    lab = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="label_propagate"):
        tl.label_propagate(lab, 4)
