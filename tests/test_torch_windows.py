"""Parity of the port's window gather (kernel K4's plain version) with
the JAX package: exact copies, against the jnp chunked path and the
Pallas kernel in interpret mode (blackbox_tpu/pallas/gather.py).

JAX computes every slot of a block (Pallas) or 2048-slot chunk (jnp)
that starts below ``n_active``, while the port zeroes each slot from
``n_active`` on; parity is therefore defined on slots < n_active, and
the port's slots from there on must be zeros.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_exact, t  # noqa: E402
from blackbox_tpu.ops.windows import gather_slot_windows as jgather  # noqa: E402
from blackbox_tpu.pallas.gather import gather_windows  # noqa: E402
from blackbox_tpu_torch.ops.windows import gather_slot_windows  # noqa: E402


def _frames(rng, H, W):
    img = rng.normal(size=(H, W)).astype(np.float32)
    seg = rng.integers(0, 9999, size=(H, W)).astype(np.int32)
    return img, seg


@pytest.mark.parametrize("size", [16, 25, 32])
def test_gather_matches_jnp_and_pallas(rng, size):
    H, W = 200, 260
    img, seg = _frames(rng, H, W)
    N, n_act = 37, 23
    y0 = rng.integers(-5, H + 5, N).astype(np.int32)   # out-of-range too
    x0 = rng.integers(-5, W + 5, N).astype(np.int32)
    got_f, got_i = gather_slot_windows((t(img), t(seg)), t(y0), t(x0), size,
                                       n_active=torch.tensor(n_act))
    want_f, want_i = jgather((jnp.asarray(img), jnp.asarray(seg)),
                             jnp.asarray(y0), jnp.asarray(x0), size,
                             n_active=jnp.int32(n_act), use_pallas=False)
    pal_f, pal_i = gather_windows((jnp.asarray(img), jnp.asarray(seg)),
                                  jnp.asarray(y0), jnp.asarray(x0), size,
                                  n_active=jnp.int32(n_act), interpret=True,
                                  blk=8)
    for got, want, pal in ((got_f, want_f, pal_f), (got_i, want_i, pal_i)):
        assert_exact(got[:n_act], np.asarray(want)[:n_act])
        assert_exact(got[:n_act], np.asarray(pal)[:n_act])
        assert not got[n_act:].any()


def test_gather_all_live_and_dtypes(rng):
    """No n_active: every slot live; bool frames are widened and come
    back as bool; a single image returns a single stack."""
    H, W = 60, 80
    img, _ = _frames(rng, H, W)
    msk = rng.random((H, W)) > 0.5
    N, size = 2100, 12                       # more than one jnp chunk
    y0 = rng.integers(0, H, N).astype(np.int32)
    x0 = rng.integers(0, W, N).astype(np.int32)
    got_f, got_b = gather_slot_windows((t(img), t(msk)), t(y0), t(x0), size)
    want_f, want_b = jgather((jnp.asarray(img), jnp.asarray(msk)),
                             jnp.asarray(y0), jnp.asarray(x0), size,
                             use_pallas=False)
    assert_exact(got_f, want_f)
    assert_exact(got_b, want_b)
    one = gather_slot_windows(t(img), t(y0), t(x0), size)
    assert_exact(one, want_f)


def test_kernel_wrapper_never_falls_back():
    img = torch.zeros((16, 16), device="meta")
    y0 = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="gather_slot_windows"):
        gather_slot_windows(img, y0, y0, 4)
