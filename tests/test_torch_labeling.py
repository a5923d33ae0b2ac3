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


def _min3x3(a, big):
    p = torch.nn.functional.pad(a, (1, 1, 1, 1), value=big)
    out = p[1:-1, 1:-1]
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = torch.minimum(out, p[dy:dy + a.shape[0], dx:dx + a.shape[1]])
    return out


def _schedule_model(lab, steps):
    """The schedule of csrc/labelprop.cu in plain PyTorch: T x T tiles
    (T = 32 up to 60 steps, else 16); a tile with no foreground is all
    BIG; any other is loaded with a ``steps``-wide halo (BIG outside the
    frame) into two buffers, and step s updates, from one buffer into
    the other, only the foreground within steps - 1 - s of the interior
    (entries outside keep what the buffer held), stopping after the
    first step that changes nothing there."""
    H, W = lab.shape
    big = H * W + 2
    T = 32 if steps <= 60 else 16
    S = T + 2 * steps
    out = torch.full_like(lab, big)
    padded = torch.nn.functional.pad(torch.clamp(lab, max=big),
                                     (steps, steps + T, steps, steps + T),
                                     value=big)
    for y0 in range(0, H, T):
        for x0 in range(0, W, T):
            if not bool((lab[y0:y0 + T, x0:x0 + T] < big).any()):
                continue
            a = padded[y0:y0 + S, x0:x0 + S].clone()
            b = a.clone()
            fg = a < big
            for s in range(steps):
                act = torch.zeros_like(fg)
                act[s + 1:S - 1 - s, s + 1:S - 1 - s] = \
                    fg[s + 1:S - 1 - s, s + 1:S - 1 - s]
                b = torch.where(act, _min3x3(a, big), b)
                changed = bool((b != a)[act].any())
                a, b = b, a
                if not changed:
                    break
            h, w = min(T, H - y0), min(T, W - x0)
            out[y0:y0 + h, x0:x0 + w] = a[steps:steps + h, steps:steps + w]
    return out


def _schedule_mask(kind, rng, H, W, steps):
    if kind == "random":
        return rng.random((H, W)) > 0.45
    if kind == "blobs":
        return _blobby_mask(rng, H, W, nblobs=12)
    m = np.zeros((H, W), bool)          # wider than 2 x steps: never still
    m[5:H - 3, 7:W - 2] = True
    m[H // 2, :] = False
    return m


@pytest.mark.parametrize("steps", [1, 16, 48, 64])
@pytest.mark.parametrize("kind", ["random", "blobs", "rectangle"])
def test_kernel_schedule_model_matches_plain(rng, steps, kind):
    """The K1 kernel's tiles, halo, shrinking region and stop rule, run
    as a PyTorch model, give the plain version's labels exactly, on
    frames that are not a multiple of the tile."""
    H, W = 75, 141
    mask = _schedule_mask(kind, rng, H, W, steps)
    idx = np.arange(1, H * W + 1, dtype=np.int32).reshape(H, W)
    lab0 = t(np.where(mask, idx, np.int32(H * W + 2)))
    want = tl._label_propagate_plain(lab0, steps)
    assert torch.equal(_schedule_model(lab0, steps), want)
