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

from torch_parity import (K7_OVERFLOW_PATCH, assert_exact,  # noqa: E402
                          cosmic_scene as _scene, t)
from blackbox_tpu.ops import cosmics as jcos  # noqa: E402
from blackbox_tpu.pallas.lacosmic import lacosmic_pallas  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.ops import cosmics  # noqa: E402
from blackbox_tpu_torch.ops import lacosmic_fused as K7  # noqa: E402
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


# ---- csrc/lacosmic.cu's two skip predicates, modelled in PyTorch --------

BOUND = 2.0 ** 100     # the kernel's small(): |x| below 2^100


def _window_all(mask, k):
    """AND over the k x k window of each pixel, edge-clamped reads."""
    p = k // 2
    h, w = mask.shape
    mp = K7._edge(mask.to(torch.float32), p)
    out = torch.ones_like(mask)
    for dy in range(k):
        for dx in range(k):
            out = out & (mp[dy:dy + h, dx:dx + w] > 0)
    return out


def _is_pos_zero(x):
    return x.view(torch.int32) == 0


def _skip_iter(clean, inm, crm, rdn, sigclip, sigfrac, objlim):
    """``_tile_iter`` with csrc/lacosmic.cu's skips: the 7x7 median is
    poisoned (NaN) where ``stage2`` skips it and c1 is +0 * good there;
    the masked clean is poisoned where ``grow_scan`` skips it and
    out_c is clean there (inm is 0 or 1, as the kernel reads it).
    Returns the result and the two skip maps.  Each clause of the two
    tests is needed by one of the predicate frames: gt(sp, sigclip) and
    crm2 == +0 by the plain frame, the 7x7 window of m3 by "overflow",
    the finite objlim by the "objlim_nan" thresholds, clean != 0 by
    "zeros", the 5x5 window of clean by "inf", and the 5x5 window of
    crm2 by "nan", "inf" and "crm"."""
    small = lambda x: torch.abs(x) < BOUND  # noqa: E731
    unit = lambda x: (x >= 0) & (x <= 1)    # noqa: E731
    m5 = torch.clamp(K7._median_edge(clean, 5), min=1e-5)
    rr = rdn * rdn
    noise = torch.sqrt(m5 + rr)
    s = K7._laplacian(clean) / (2.0 * noise)
    sp = s - K7._median_edge(s, 5)
    m3 = K7._median_edge(clean, 3)
    g1 = K7._gt(sp, sigclip)
    skip7 = (_is_pos_zero(g1) & _window_all(small(m3), 7)
             & bool(np.isfinite(objlim)))
    m37 = torch.where(skip7, torch.nan, K7._median_edge(m3, 7))
    f = torch.clamp((m3 - m37) / noise, min=0.01)
    good = 1.0 - inm
    cosm = torch.where(skip7, g1 * good,
                       g1 * K7._gt(sp / f, objlim) * good)
    cosm = K7._dilate(cosm, 3) * K7._gt(sp, sigclip) * good
    cosm = K7._dilate(cosm, 5) * K7._gt(sp, sigclip * sigfrac) * good
    crm2 = torch.maximum(crm, cosm)
    skipc = (_is_pos_zero(crm2) & (clean != 0)
             & _window_all(small(clean) & unit(crm2), 5))
    repl = torch.where(skipc, torch.nan,
                       K7._masked_median5(clean, torch.maximum(crm2, inm),
                                          m5))
    out = torch.where(skipc, clean, clean + crm2 * (repl - clean))
    return (out, crm2), skip7, skipc


def _bits_equal(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _predicate_frame(kind, rng, H=40, W=60):
    """A sky with stars and isolated cosmics, plus the case's specials;
    returns the frame, the exclusion mask, the read noise and the
    cosmic mask the iteration starts from."""
    img = 100.0 + 10.0 * rng.standard_normal((H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x in ((10, 12), (28, 45)):
        img += 4e3 * np.exp(-0.5 * ((yy - y) ** 2 + (xx - x) ** 2) / 2.0)
    # a sharp star: sp above sigclip, sp / f below objlim
    img += 3e4 * np.exp(-0.5 * ((yy - 34) ** 2 + (xx - 8) ** 2) / 0.8)
    for y, x in ((5, 30), (20, 8), (33, 20), (15, 50)):
        img[y, x] += 2e4
    inm = np.zeros((H, W), np.float32)
    rdn = 6.0
    if kind == "zeros":                  # +-0 pixels and a zero plateau
        img[2:8, 2:8] = 0.0
        img[12, 30] = -0.0
        img[rng.random((H, W)) < 0.03] = -0.0
    elif kind == "nan":
        img[18, 25] = np.nan
        img[3, 50] = np.nan
    elif kind == "inf":
        img[8, 40] = np.inf
        img[30, 10] = -np.inf
    elif kind == "ties":                 # values equal to the blend's BIG
        img[20:23, 30:33] = 1e30
        img[5, 5] = 1e30
    elif kind == "huge":                 # around the 2^100 bound
        img[10, 20] = 2.0 ** 100
        img[25, 40] = -3e38
        img[30, 5] = 1e35
    elif kind == "clustered":            # hits that touch each other
        img[10:13, 30:34] += 2e4
        img[11, 35] += 2e4
        img[26:28, 12:14] += 3e4
    elif kind == "allbad":               # all-bad neighbourhoods
        inm[5:14, 20:29] = 1.0
        img[9, 24] += 2e4
        inm[30:36, 40:46] = 1.0
        img[32, 38] += 2e4
    elif kind == "rdn_nan":
        rdn = np.nan
    elif kind == "rdn_inf":
        rdn = np.inf
    elif kind == "overflow":
        img[10:32, 15:37] = 100.0
        img[18:24, 23:30] = K7_OVERFLOW_PATCH
        rdn = 0.0
    crm = np.zeros((H, W), np.float32)
    if kind == "crm":                    # a mask from outside [0, 1]
        crm[12, 20] = np.nan
        crm[25, 33] = 2.0
        crm[30, 50] = 1e30
        crm[8, 8] = 0.5
    return (t(img.astype(np.float32)), t(inm),
            torch.tensor(rdn, dtype=torch.float32), t(crm))


THRESHOLDS = {"production": (15.0, 0.01, 3.0), "zero": (0.0, 0.0, 0.0),
              "objlim_nan": (15.0, 0.01, np.nan)}


@pytest.mark.parametrize("thresholds", list(THRESHOLDS))
@pytest.mark.parametrize("kind", ["plain", "zeros", "nan", "inf", "ties",
                                  "huge", "clustered", "allbad", "rdn_nan",
                                  "rdn_inf", "overflow", "crm"])
def test_skip_predicates_match_dense(kind, thresholds):
    """The 7x7 median's and the masked clean's skip predicates: with the
    skipped values poisoned, two iterations (the second from the
    first's cosmic mask) equal the dense ``_tile_iter`` bit for bit, on
    +-0, NaN, +-inf, 1e30 ties with the blend's BIG, values around the
    2^100 bound, clustered hits, all-bad neighbourhoods, a NaN and an
    infinite read noise, a ratio m3 / noise that overflows, a starting
    mask outside [0, 1] and a NaN objlim."""
    sig = THRESHOLDS[thresholds]
    clean, inm, rdn, crm = _predicate_frame(kind, np.random.default_rng(3))
    for _ in range(2):
        want = K7._tile_iter(clean, inm, crm, rdn, *sig)
        got, skip7, skipc = _skip_iter(clean, inm, crm, rdn, *sig)
        assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
        # a NaN or infinite read noise or objlim leaves one path idle
        if kind[:4] != "rdn_" and thresholds != "objlim_nan":
            assert bool(skip7.any()) and bool(skipc.any())
            assert bool((~skipc).any())
        clean, crm = want
