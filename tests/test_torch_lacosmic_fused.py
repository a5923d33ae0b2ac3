"""K7, the fused L.A.Cosmic iteration: the port's plain version
(``ops/lacosmic_fused``) against the JAX package's Pallas kernel run in
interpret mode (``lacosmic_pallas(..., interpret=True)``), as
tests/test_pallas_lacosmic.py runs it.

Tolerances: none.  ``crmask``, ``counts`` and ``clean`` are held bit
for bit: the plain version repeats the kernel's float32 arithmetic
operation by operation (its only difference, the choice of median
network, cannot change a median's value), and XLA's CPU code for the
interpreted kernel rounded every operation the same way here.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_exact, cosmic_scene as _scene, t  # noqa: E402
from blackbox_tpu.ops import cosmics as jcos  # noqa: E402
from blackbox_tpu.pallas.lacosmic import lacosmic_pallas  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.ops import cosmics  # noqa: E402
from blackbox_tpu_torch.ops.lacosmic_fused import (lacosmic_fused,  # noqa: E402
                                                   padded_shape)


def _compare(img, inmask, rdn, niter, **kw):
    want = lacosmic_pallas(jnp.asarray(img),
                           None if inmask is None else jnp.asarray(inmask),
                           jnp.float32(rdn), niter=niter, interpret=True,
                           **kw)
    got = lacosmic_fused(t(img), None if inmask is None else t(inmask),
                         torch.tensor(rdn), niter=niter, **kw)
    assert int(np.asarray(want[2]).sum()) > 0
    assert_exact(got[1], want[1], "crmask")
    assert_exact(got[2].to(torch.int32), want[2], "counts")
    assert_exact(got[0], want[0], "clean")
    return got


def test_k7_matches_pallas_132x264():
    """The Pallas test's multi-tile scene, 2 iterations, no inmask."""
    _compare(_scene(1, 132, 264, 25), None, 10.0, 2, sigclip=10.0)


def test_k7_matches_pallas_tiny_mosaic():
    """A TINY-mosaic-sized scene (W = 320 pads to 512, so the right edge
    is the padded one) with stars and an inmask block, 3 iterations at
    the production thresholds."""
    H, W = TINY.red_shape
    img = _scene(2, H, W, 30, nstars=12)
    inmask = np.zeros((H, W), bool)
    inmask[40:52, 100:130] = True
    clean, crmask, _ = _compare(img, inmask, 6.0, 3)
    assert not bool(crmask[40:52, 100:130].any())


@pytest.mark.parametrize("shape", [(5, 7), (132, 320), (10560, 10560)])
def test_padded_shape_copy(shape):
    """The (Hp, Wp) rule is the one lacosmic_pallas pads to: read from
    the output shape of its pallas_call, traced, never run."""
    def find(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                return eqn.outvars[0].aval.shape
            for p in eqn.params.values():
                inner = getattr(p, "jaxpr", p)
                if hasattr(inner, "eqns"):
                    found = find(inner)
                    if found is not None:
                        return found
        return None

    H, W = shape
    jaxpr = jax.make_jaxpr(functools.partial(lacosmic_pallas, niter=1))(
        jax.ShapeDtypeStruct((H, W), jnp.float32),
        jax.ShapeDtypeStruct((H, W), bool),
        jax.ShapeDtypeStruct((), jnp.float32))
    assert tuple(find(jaxpr.jaxpr)) == padded_shape(H, W)


def test_lacosmic_routes_use_pallas_to_k7():
    """``LACosmicParams(use_pallas=True)`` runs K7 (its plain version
    here) with the params' thresholds, like the JAX package."""
    img = _scene(3, 64, 96, 8)
    p = cosmics.LACosmicParams(use_pallas=True, sigclip=10.0, niter=2)
    got = cosmics.lacosmic(t(img), None, 5.0, p)
    want = lacosmic_fused(t(img), None, 5.0, sigclip=10.0, niter=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(prescreen=True, windowed=False),
    dict(prescreen=True, sepmed=True),
    dict(prescreen=True, use_pallas=True, sepmed=True),
])
def test_prescreen_argument_checks(kw):
    """The JAX package's ValueErrors for ``prescreen`` without the
    windowed machinery, raised before any route is taken."""
    img = _scene(4, 32, 40, 2)
    with pytest.raises(ValueError, match="prescreen"):
        jcos.lacosmic(jnp.asarray(img), None, jnp.float32(5.0),
                      jcos.LACosmicParams(**kw))
    with pytest.raises(ValueError, match="prescreen"):
        cosmics.lacosmic(t(img), None, 5.0, cosmics.LACosmicParams(**kw))


def test_prescreen_needs_scalar_read_noise():
    img = _scene(5, 32, 40, 2)
    rdn = np.full(img.shape, 5.0, np.float32)
    with pytest.raises(ValueError, match="SCALAR"):
        jcos.lacosmic(jnp.asarray(img), None, jnp.asarray(rdn),
                      jcos.LACosmicParams(prescreen=True))
    with pytest.raises(ValueError, match="SCALAR"):
        cosmics.lacosmic(t(img), None, t(rdn),
                         cosmics.LACosmicParams(prescreen=True))


def test_rejects_malformed_inputs():
    """The wrapper checks what reaches the kernel: an inmask of another
    shape, and a read-noise map (K7 takes a scalar, as lacosmic_pallas
    does)."""
    img = t(_scene(6, 16, 24, 2))
    with pytest.raises(ValueError, match="inmask"):
        lacosmic_fused(img, torch.zeros((16, 23), dtype=torch.bool), 5.0)
    with pytest.raises(ValueError, match="scalar"):
        lacosmic_fused(img, None, torch.full((16, 24), 5.0))
