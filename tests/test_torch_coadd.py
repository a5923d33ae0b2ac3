"""The port's co-add (ops/coadd.py, ops/filters.fixpix and the combiners
of pipeline/buildref.py) against the JAX package on the CPU: the same
numpy inputs through both.

Tolerances:
- masks, ``nclipped`` and the first-guess median: bit for bit
  (``nclipped`` of the combiners but for the clip flips below);
- the combine's floats (image, weight sum, background STD, effective
  headers): within 1e-5 of themselves, plus, for the remapped images,
  1e-3 e- (the coordinate planes come from float32 matmuls, whose sums
  differ in order between the two packages' CPU backends, which moves
  a sample on a 2e4 e- star's gradient by a fraction of that);
- the blocked combiner against the resident one, in the port as in the
  JAX package (tests/test_coadd.py): the two remap with different shift
  ranges and from different coordinate origins, so a pixel at the clip
  threshold may flip its decision (at most 1e-3 of the pixels), and
  the image differs by up to 0.05 e- on the star's steep gradient,
  under 1% of the sky noise; masks and, where no clip flipped, the
  weight sums agree;
- the blocked combiner's two background-STD sources (full-res planes,
  or the mini mesh rebuilt a slab at a time): the full plane is
  mini2back's ``(Wy @ mesh) @ Wx.T`` over every row, the slab's the
  same product over its rows, and the BLAS may block the two shapes
  differently, so a row may round differently; held at the combine's
  tolerances, masks and clip decisions equal.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_parity as TP  # noqa: E402
from torch_parity import assert_close, assert_exact, n, t  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from blackbox_tpu.core import maskbits as mb  # noqa: E402
from blackbox_tpu.ops import coadd as JC  # noqa: E402
from blackbox_tpu.ops import filters as JF  # noqa: E402
from blackbox_tpu.pipeline import buildref as JB  # noqa: E402
from blackbox_tpu.astro.wcs import TanWCS as JWCS  # noqa: E402
from blackbox_tpu_torch.astro.wcs import TanWCS  # noqa: E402
from blackbox_tpu_torch.ops import coadd as TC  # noqa: E402
from blackbox_tpu_torch.ops import filters as TF  # noqa: E402
from blackbox_tpu_torch.pipeline import buildref as TB  # noqa: E402

IMG_ATOL = 1e-3        # e-, the remapped images (module note)
BLOCK_ATOL = 0.05      # e-, blocked against resident (module note)
FLIP_FRAC = 1e-3       # clip decisions that may flip, blocked/resident


def _stack(seed, N=5, H=48, W=56, absent=0.3):
    """A noise stack with outliers, its weights (``absent`` of them
    zero, and a corner where no input is present), sigmas and a mask
    stack with saturated, cosmic and edge bits."""
    rng = np.random.default_rng(seed)
    stack = rng.normal(0, 5, (N, H, W)).astype(np.float32)
    stack[1, 10:14, 10:14] += 300.0
    stack[3, 30, :] += 200.0
    w = np.full((N, H, W), 1 / 25.0, np.float32)
    w[rng.random((N, H, W)) < absent] = 0
    w[:, :3, :3] = 0
    sig = rng.uniform(4, 6, N).astype(np.float32)
    m = np.zeros((N, H, W), np.uint8)
    m[0, 20, 20] = mb.SATURATED
    m[2, 40, 50] = mb.SAT_CONNECTED
    m[1, 0, W - 1] = mb.SATURATED            # a corner: only in-frame counts
    m[:3, 5, 5] = mb.BAD
    m[0, 6, 6] = mb.COSMIC
    m[:, 44, :] |= mb.EDGE
    m[:2, 45, :] |= mb.EDGE
    return stack, w, sig, m


def test_weighted_coadd_and_bkg_std():
    stack, w, _, _ = _stack(0)
    co, ws = TC.weighted_coadd(t(stack), t(w))
    jco, jws = JC.weighted_coadd(jnp.asarray(stack), jnp.asarray(w))
    assert_close(co, jco, 1e-5, what="coadd")
    assert_close(ws, jws, 1e-5, what="wsum")
    assert_close(TC.coadd_bkg_std(ws), JC.coadd_bkg_std(jws), 1e-5)


@pytest.mark.parametrize("r", [0, 1, 4, 12])
def test_saturation_protect(r):
    _, _, _, m = _stack(1)
    assert_exact(TC.saturation_protect(t(m), r),
                 JC.saturation_protect(jnp.asarray(m), r), f"r={r}")


@pytest.mark.parametrize("npres", [0, 1, 2, 3, 4, 5])
def test_first_guess_median(npres):
    """jnp.nanmedian along the stack: the two middle values averaged at
    an even count, 0 where nothing is present (after nan_to_num)."""
    rng = np.random.default_rng(npres)
    N, H, W = 5, 16, 24
    big = rng.normal(0, 10, (N, H, W)).astype(np.float32)
    # exactly npres present values a pixel, at random places in the stack
    order = np.argsort(rng.random((N, H, W)), axis=0)
    big[order >= npres] = np.nan
    got = torch.nan_to_num(TC.nanmedian_stack(t(big)))
    want = jnp.nan_to_num(jnp.nanmedian(jnp.asarray(big), axis=0))
    assert_exact(got, want, f"{npres} present")
    if npres == 0:
        assert not n(got).any()
    if npres in (2, 4):
        # the mean of the two middle values, not the lower one
        lo = torch.nanmedian(t(big), dim=0).values
        assert (n(got) != n(lo)).mean() > 0.9


CLIP_CASES = {
    # even and odd present counts, all-absent pixels
    "plain": dict(),
    "protect": dict(protect=6),
    # fewer than nmin_clip inputs present: no clipping there
    "nmin_clip": dict(params=JC.ClipParams(nmin_clip=5)),
    # two present, one at -100 and one at +100: both clipped, weights
    # restored ("never clip all")
    "never_clip_all": dict(params=JC.ClipParams(nmin_clip=2), pair=True),
    "A_and_nsigma": dict(params=JC.ClipParams(A=2.0, nsigma=3.5)),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clipped_coadd(case):
    kw = CLIP_CASES[case]
    stack, w, sig, m = _stack(2)
    if kw.get("pair"):
        w[:] = 0
        w[:2] = 1 / 25.0
        stack[0, 8:12, 8:12] = -100.0
        stack[1, 8:12, 8:12] = 100.0
    jp = kw.get("params", JC.ClipParams())
    tp = TC.ClipParams(**dataclasses.asdict(jp))
    jprot = tprot = None
    if "protect" in kw:
        jprot = JC.saturation_protect(jnp.asarray(m), kw["protect"])
        tprot = TC.saturation_protect(t(m), kw["protect"])
    co, ws, nc = TC.clipped_coadd(t(stack), t(w), t(sig), tp, protect=tprot)
    jco, jws, jnc = JC.clipped_coadd(jnp.asarray(stack), jnp.asarray(w),
                                     jnp.asarray(sig), jp, protect=jprot)
    assert_exact(nc, jnc, "nclipped")
    assert_close(co, jco, 1e-5, 1e-6, what="coadd")
    assert_close(ws, jws, 1e-5, what="wsum")
    nc = n(nc)
    assert nc.sum() > 0
    if case == "never_clip_all":
        assert (nc[8:12, 8:12] == 2).all()
        assert np.allclose(n(co)[8:12, 8:12], 0.0)
        assert np.allclose(n(ws)[8:12, 8:12], 2 / 25.0)
    if case == "nmin_clip":
        npres = (w > 0).sum(0)
        assert not nc[npres < 5].any()


@pytest.mark.parametrize("or_bits, vote", [(None, 0.5), (mb.BAD, 0.3)])
def test_coadd_mask(or_bits, vote):
    _, _, _, m = _stack(3)
    assert_exact(TC.coadd_mask(t(m), or_bits, vote),
                 JC.coadd_mask(jnp.asarray(m), or_bits, vote))


def test_effective_headers():
    rng = np.random.default_rng(4)
    args = [rng.uniform(0.5, 2, 6).astype(np.float32) for _ in range(5)]
    got = TC.effective_headers(*args)
    want = JC.effective_headers(*(jnp.asarray(a) for a in args))
    for g, w_ in zip(got, want):
        assert_close(g, w_, 1e-6)


def test_fixpix():
    """Masked pixels away from the 2-px border (which keeps its input)
    filled from the good neighbours' median; of a 9x9 all-bad block,
    the first pass fills the two outer rings, whose 5x5 window reaches
    a good pixel, the second all but the centre."""
    rng = np.random.default_rng(5)
    img = rng.normal(100, 5, (70, 90)).astype(np.float32)
    bad = rng.random((70, 90)) < 0.05
    block = np.zeros_like(bad)
    block[20:29, 30:39] = True
    bad |= block
    img[bad] = 6e4
    got = TF.fixpix(t(img), t(bad))
    want = JF.fixpix(jnp.asarray(img), jnp.asarray(bad))
    assert_exact(got, want)
    g = n(got)
    inner = np.zeros_like(bad)
    inner[2:-2, 2:-2] = True
    assert (g[bad & inner & ~block] < 1e3).all()
    assert (g[20:29, 30:39] < 1e3).sum() == 9 * 9 - 1 and g[24, 34] == 6e4


# ------------------------------------------------------------ combiners

H = W = 128
BOX = 32


def _inputs(seed, N=5, mini=False):
    """Paired co-add inputs (JAX RefInputs, the port's RefInputs) of one
    field: a star seen through N dithered, rotated WCSs at different
    zeropoints, a saturated footprint near a block seam with an outlier
    inside its protection zone, a cosmic to clip, and a
    background-STD plane that is the Catmull-Rom upsample of a mini
    mesh (carried as ``bkg_std_mini`` when ``mini``)."""
    from blackbox_tpu.synth.generator import star_image
    from blackbox_tpu_torch.ops.background import mini2back
    rng = np.random.default_rng(seed)
    wcs_out = JWCS.simple(150.0, -30.0, 0.5642, (H, W))
    jin, tin = [], []
    for i in range(N):
        wkw = dict(rot_deg=0.5 * i)
        cen = (150.0 + 1e-4 * i, -30.0 - 5e-5 * i, 0.5642, (H, W))
        jw = JWCS.simple(*cen, **wkw)
        ra, dec = wcs_out.pix2sky(64.0, 64.0)
        xi, yi = jw.sky2pix(ra, dec)
        zp_i = 25.0 - 0.1 * i
        fs = 10.0 ** (0.4 * (25.0 - zp_i))
        img = star_image((H, W), [[float(xi), float(yi), 2.0e4 / fs, 3.0]])
        img = (img + rng.normal(0, 4.0, (H, W))).astype(np.float32)
        mask = np.zeros((H, W), np.uint8)
        mask[27:30, 60:63] = mb.SATURATED
        if i == 1:
            img[38, 61] += 160.0
        if i == 2:
            img[90, 20] += 500.0
        stdm = (4.0 + 0.5 * rng.random((H // BOX, W // BOX))).astype(
            np.float32)
        std = mini2back(t(stdm), (H, W), BOX).numpy()
        extra = dict(bkg_std_mini=stdm, bkg_boxsize=BOX) if mini else {}
        jin.append(JB.RefInput(image=jnp.asarray(img),
                               bkg_std=jnp.asarray(std),
                               mask=jnp.asarray(mask), wcs=jw, zp=zp_i,
                               fwhm_pix=2.5, **extra))
        tin.append(TB.RefInput(image=t(img), bkg_std=t(std), mask=t(mask),
                               wcs=TanWCS.simple(*cen, **wkw), zp=zp_i,
                               fwhm_pix=2.5, **extra))
    return jin, tin, wcs_out, TanWCS.simple(150.0, -30.0, 0.5642, (H, W))


def _same_inputs_check(got, want, what):
    """The port's combine against the JAX package's (module note)."""
    assert_exact(got["mask"], want["mask"], what + " mask")
    assert_exact(np.asarray(n(got["nclipped"]), np.int32),
                 np.asarray(n(want["nclipped"]), np.int32),
                 what + " nclipped")
    assert_close(got["image"], want["image"], 1e-5, IMG_ATOL,
                 what + " image")
    assert_close(got["wsum"], want["wsum"], 1e-5, what=what + " wsum")
    assert_close(got["bkg_std"], want["bkg_std"], 1e-5,
                 what=what + " bkg_std")
    np.testing.assert_array_equal(got["fscales"], want["fscales"])
    assert got["zp"] == want["zp"] and got["nimages"] == want["nimages"]


def _blocked_vs_resident(blk, res, what):
    """tests/test_coadd.py's blocked-against-resident contract."""
    flip = n(blk["nclipped"]) != n(res["nclipped"])
    assert flip.mean() < FLIP_FRAC, (what, flip.sum())
    same = ~flip
    d = np.abs(n(blk["image"]) - n(res["image"]))
    assert d[same].max() < BLOCK_ATOL, (what, d[same].max())
    np.testing.assert_allclose(n(blk["wsum"])[same], n(res["wsum"])[same],
                               atol=1e-5, err_msg=what)
    assert_exact(blk["mask"], res["mask"], what + " mask")


@pytest.fixture(scope="module")
def resident():
    """coadd_field on both remaps, both packages: {remap: (port, jax)}."""
    jin, tin, jw, tw = _inputs(6)
    out = {}
    for remap in ("shift2pass", "gather"):
        out[remap] = (TB.coadd_field(tin, tw, (H, W), remap=remap,
                                     device="cpu"),
                      JB.coadd_field(jin, jw, (H, W), remap=remap))
    return out


@pytest.mark.parametrize("remap", ["shift2pass", "gather"])
def test_coadd_field_matches_jax(resident, remap):
    got, want = resident[remap]
    for k in ("image", "bkg_std", "mask", "wsum", "nclipped"):
        assert got[k].device.type == "cpu", k
    assert got["nclipped"].dtype == torch.int32
    _same_inputs_check(got, want, remap)
    co = n(got["image"])
    # the star's flux at the common zeropoint, the cosmic and the
    # outlier clipped
    assert abs(co[52:77, 52:77].sum() / 2.0e4 - 1.0) < 0.03
    assert n(got["nclipped"]).sum() > 0


@pytest.mark.parametrize("remap, std", [
    ("shift2pass", "full"), ("shift2pass", "mini"), ("gather", "full"),
    ("gather", "mini")])
def test_blocked_matches_jax_and_resident(resident, remap, std):
    jin, tin, jw, tw = _inputs(6, mini=std == "mini")
    kw = dict(block_rows=32, pad_rows=16, remap=remap)
    got = TB.coadd_field_blocked(tin, tw, (H, W), device="cpu", **kw)
    want = JB.coadd_field_blocked(jin, jw, (H, W), **kw)
    for k in ("image", "bkg_std", "mask", "wsum", "nclipped"):
        assert isinstance(got[k], np.ndarray), k
    assert got["nclipped"].dtype == np.int32
    _same_inputs_check(got, want, f"{remap} {std}")
    _blocked_vs_resident(got, resident[remap][0], f"{remap} {std}")


def test_blocked_mini_std_matches_full_res_std():
    """The mini-mesh std source against the full-res planes (module
    note)."""
    _, full, _, tw = _inputs(7)
    _, mini, _, _ = _inputs(7, mini=True)
    kw = dict(block_rows=32, pad_rows=16, device="cpu")
    a = TB.coadd_field_blocked(full, tw, (H, W), **kw)
    b = TB.coadd_field_blocked(mini, tw, (H, W), **kw)
    for k in ("nclipped", "mask"):
        assert_exact(b[k], a[k], k)
    assert_close(b["image"], a["image"], 1e-5, IMG_ATOL, "image")
    for k in ("wsum", "bkg_std"):
        assert_close(b[k], a[k], 1e-5, what=k)


def test_blocked_instrumented():
    """instrument=True returns the stage breakdown and the outputs of
    the pipelined run, unchanged."""
    _, tin, _, tw = _inputs(8, N=3)
    kw = dict(block_rows=48, pad_rows=8, device="cpu")
    a = TB.coadd_field_blocked(tin, tw, (H, W), **kw)
    b = TB.coadd_field_blocked(tin, tw, (H, W), instrument=True, **kw)
    tim = b["timings"]
    assert tim["nblocks"] == 3
    assert all(tim[k] >= 0 for k in ("prep_s", "upload_s", "compute_s",
                                     "drain_s"))
    assert tim["compute_s"] > 0
    for k in ("image", "wsum", "nclipped", "mask", "bkg_std"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "timings" not in a


def test_weighted_when_too_few_to_clip(resident):
    """Below nmin_clip inputs (or combine_type="weighted") the combiners
    take the plain weighted mean and clip nothing, as the JAX package
    does."""
    jin, tin, jw, tw = _inputs(9, N=2)
    s = TB.BuildRefSettings()
    js = JB.BuildRefSettings()
    got = TB.coadd_field(tin, tw, (H, W), s, device="cpu")
    want = JB.coadd_field(jin, jw, (H, W), js)
    _same_inputs_check(got, want, "N=2")
    assert not n(got["nclipped"]).any()
    s3 = dataclasses.replace(s, combine_type="weighted")
    jin, tin, jw, tw = _inputs(9, N=3)
    blk = TB.coadd_field_blocked(tin, tw, (H, W), s3, block_rows=64,
                                 pad_rows=16, device="cpu")
    want = JB.coadd_field_blocked(
        jin, jw, (H, W), dataclasses.replace(js, combine_type="weighted"),
        block_rows=64, pad_rows=16)
    _same_inputs_check(blk, want, "weighted")
    assert not blk["nclipped"].any()


def test_defaults_to_the_card():
    """The combiners put their work on the card unless asked otherwise:
    with no CUDA device they fail rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tin, _, tw = _inputs(10, N=3)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        TB.coadd_field(tin, tw, (H, W))
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        TB.coadd_field_blocked(tin, tw, (H, W), block_rows=64)


def test_clip_settings_copy():
    """ClipParams and BuildRefSettings carry the JAX package's fields and
    defaults."""
    assert dataclasses.asdict(TC.ClipParams()) == \
        dataclasses.asdict(JC.ClipParams())
    got = dataclasses.asdict(TB.BuildRefSettings())
    want = dataclasses.asdict(JB.BuildRefSettings())
    assert got == want
