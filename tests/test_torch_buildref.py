"""The port's reference co-add (``pipeline/buildref.build_reference``)
against the JAX package's on a TINY tree: three reduced visits of field
42 (``night_parity.tiny_visits``, reduced once by the port, the first
adopted as the field reference), copied once for each package, then
``build_reference`` with an extraction context in each copy, three
times:

1. with the default not-deeper gate (``dlimmag_min`` = 0.1 mag):
   ``not_deeper`` in both packages, a fault of the reference that the
   port matches: ``build_reference`` states the co-add's LIMMAG for an
   exposure of 1 s (``limiting_magnitude(zp, std, 3.0, 1.0)``) while
   a frame's LIMMAG counts its EXPTIME, so against a single-frame
   reference of 60 s the co-add comes out 2.5·log10(60) = 4.45 mag too
   shallow and never replaces it;
2. with the gate lowered by that 4.45 mag: ``published``, the adopted
   frame archived under ``ref-old/``;
3. again with the default gate: ``not_deeper`` (same inputs, same
   depth).

What is held, product by product of the second call:
- status and info, header keywords: the same keys; integer, string and
  boolean values equal (NIMAGES, NOBJECTS, R-IM*, the WCS, R-ASWARP,
  R-NSIGMA); LIMMAG and S-SEEING within 1e-3 mag / 2e-3 of themselves;
- the mask: bit for bit;
- the image and the background STD map: within one Rice step, plus
  1e-3 e- and 1e-5 of themselves (the combine's tolerances of
  ``test_torch_coadd.py``);
- the catalog: ``night_parity.check_catalog_pair``'s tolerances;
- the PSF: the star count exact, the basis within 1e-5 of its largest
  value (``test_torch_psf.py``).
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import night_parity as NP  # noqa: E402
import torch_parity  # noqa: E402,F401  (pins torch threads)
from test_driver import _ctx  # noqa: E402
from blackbox_tpu.config.defaults import ReductionSettings as JSettings  # noqa: E402
from blackbox_tpu.core.geometry import TINY as JTINY  # noqa: E402
from blackbox_tpu.orchestration.paths import DataTree as JTree  # noqa: E402
from blackbox_tpu.pipeline import buildref as JB  # noqa: E402
from blackbox_tpu_torch.config.defaults import ReductionSettings  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.orchestration.paths import DataTree  # noqa: E402
from blackbox_tpu_torch.pipeline import buildref as TB  # noqa: E402

EXPTIME = 60.0
FAULT_MAG = 2.5 * np.log10(EXPTIME)     # the co-add LIMMAG's offset
STEM = os.path.join("ML1", "ref", "00042", "ML1_00042_q_coadd")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """{"port": (calls, root), "jax": (calls, root), "visits": results}:
    the three build_reference calls of each package in its copy."""
    base = str(tmp_path_factory.mktemp("coadd"))
    red = os.path.join(base, "red")
    visits = NP.tiny_visits(red, create_ref=True)
    out = {"visits": visits}
    jctx = _ctx(JSettings(geometry=JTINY, pixscale=NP.PIXSCALE))
    tctx = NP.tiny_ctx(ReductionSettings(geometry=TINY,
                                         pixscale=NP.PIXSCALE))
    for side in ("port", "jax"):
        root = os.path.join(base, side)
        shutil.copytree(red, root)
        if side == "port":
            def call(**kw):
                return TB.build_reference(
                    DataTree(root, "ML1"), "ML1", 42, "q",
                    TB.BuildRefSettings(**NP.COADD_SETTINGS),
                    extract_ctx=tctx, device="cpu", **kw)
        else:
            def call(**kw):
                return JB.build_reference(
                    JTree(root, "ML1"), "ML1", 42, "q",
                    JB.BuildRefSettings(**NP.COADD_SETTINGS),
                    extract_ctx=jctx, **kw)
        low = 0.1 - FAULT_MAG
        out[side] = ([call(), call(dlimmag_min=low), call()], root)
    return out


def test_visits_reduced(builds):
    res = builds["visits"]
    assert [r.status for r in res] == ["reduced"] * 9
    assert res[6].header["REF-NEW"] is True
    assert all(r.header["TRANS-P"] is True for r in res[7:])
    assert all(r.qc_flag != "red" for r in res[6:])


def test_limmag_fault_blocks_the_coadd(builds):
    """The reference fault (module note), in both packages: against the
    adopted single frame the co-add is not deeper by its own LIMMAG,
    and would be by 0.1 mag once the exposure time is counted."""
    old = float(builds["visits"][6].header["LIMMAG"])
    for side in ("port", "jax"):
        status, info = builds[side][0][0]
        assert status == "not_deeper", (side, status, info)
        assert info["old"] == pytest.approx(old, abs=1e-4)
        assert info["limmag"] < old - 3.0
        assert info["limmag"] + FAULT_MAG >= old + 0.1, (side, info)
    a, b = (builds[s][0][0][1]["limmag"] for s in ("port", "jax"))
    assert a == pytest.approx(b, abs=1e-3)


def test_published_and_archived(builds):
    for side in ("port", "jax"):
        calls, root = builds[side]
        status, info = calls[1]
        assert status == "published", (side, status, info)
        assert info["nimages"] == 3 and info["qc"] != "red"
        assert info["path"] == os.path.join(root, STEM + "_red.fits.fz")
        # the adopted frame's products moved under ref-old/
        arch = os.listdir(os.path.join(root, "ML1", "ref", "00042",
                                       "ref-old"))
        assert any(f.endswith("_red.fits.fz") and "coadd" not in f
                   for f in arch), arch
    p, j = (builds[s][0][1][1] for s in ("port", "jax"))
    assert p["qc"] == j["qc"]
    assert p["limmag"] == pytest.approx(j["limmag"], abs=1e-3)


def test_second_build_not_deeper(builds):
    for side in ("port", "jax"):
        status, info = builds[side][0][2]
        assert status == "not_deeper", (side, status, info)
        assert info["limmag"] == pytest.approx(info["old"], abs=1e-4)


def _header(root):
    from blackbox_tpu_torch.io.fits import read_fits
    return max((h for _, h in read_fits(os.path.join(
        root, STEM + "_red_hdr.fits"))), key=lambda h: len(h.keys()))


def test_header_keywords(builds):
    ha, hb = (_header(builds[s][1]) for s in ("port", "jax"))
    assert set(ha.keys()) == set(hb.keys())
    for k in ("NIMAGES", "NOBJECTS", "R-IM1", "R-IM3", "IMAGETYP",
              "OBJECT", "FILTER"):
        assert k in hb, k
    bad = []
    for k in hb.keys():
        x, y = ha[k], hb[k]
        if k == "LIMMAG":
            ok = abs(x - y) <= 1e-3
        elif k == "S-SEEING":
            ok = abs(x - y) <= 2e-3 * abs(y)
        else:
            ok = type(x) is type(y) and x == y
        if not ok:
            bad.append((k, x, y))
    assert not bad, bad
    assert int(ha["NIMAGES"]) == 3 and int(ha["NOBJECTS"]) >= 25


def test_mask_bit_for_bit(builds):
    from blackbox_tpu_torch.io.rice import read_rice
    x, _ = read_rice(os.path.join(builds["port"][1], STEM + "_mask.fits.fz"))
    y, _ = read_rice(os.path.join(builds["jax"][1], STEM + "_mask.fits.fz"))
    assert x.dtype == y.dtype == np.uint8
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("suffix", ["_red.fits.fz", "_bkgstd.fits.fz"])
def test_images(builds, suffix):
    x, _ = NP.decode(os.path.join(builds["port"][1], STEM + suffix))
    y, step = NP.decode(os.path.join(builds["jax"][1], STEM + suffix))
    assert x.shape == y.shape == TINY.red_shape
    tol = step + 1e-3 + 1e-5 * np.abs(y)
    assert np.all(np.abs(x - y) <= tol), float(np.abs(x - y).max())


def test_catalog(builds):
    pa, pb = (os.path.join(builds[s][1], STEM + "_red_cat.fits")
              for s in ("port", "jax"))
    NP.check_catalog_pair(pa, pb)
    assert len(NP.table(pa)["NUMBER"]) >= 25


def test_psf(builds):
    from blackbox_tpu.io.psffits import read_psf as jread
    from blackbox_tpu_torch.io.psffits import read_psf
    got = read_psf(os.path.join(builds["port"][1], STEM + "_psf.fits"),
                   device="cpu")
    want = jread(os.path.join(builds["jax"][1], STEM + "_psf.fits"))
    assert got.poldeg == want.poldeg
    assert int(got.nstars) == int(want.nstars) > 0
    b = np.asarray(want.basis)
    np.testing.assert_allclose(got.basis.numpy(), b, rtol=0,
                               atol=1e-5 * np.abs(b).max())


def test_load_ref_input_matches_jax(builds):
    """One visit's co-add input, both packages: the background-subtracted,
    fixpix-ed image and the background STD within 1e-5 of themselves
    plus 1e-3 e-, the mask and metadata equal, the mini mesh within
    1e-5."""
    import jax.numpy as jnp  # noqa: F401  (the JAX side's arrays)
    red = [p for p in builds["visits"][7].products
           if p.endswith("_red.fits.fz")][0]
    got = TB.load_ref_input(red, device="cpu")
    want = JB.load_ref_input(red)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.bkg_std.numpy(), np.asarray(want.bkg_std),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.bkg_std_mini, want.bkg_std_mini,
                               rtol=1e-5)
    for k in ("zp", "airmass", "gain", "rdnoise", "saturate", "fwhm_pix",
              "bkg_boxsize"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_allclose(got.psf_stamp, want.psf_stamp, rtol=1e-5,
                               atol=1e-7)
    assert got.image.device.type == "cpu"


def test_load_ref_input_defaults_to_the_card(builds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    red = [p for p in builds["visits"][7].products
           if p.endswith("_red.fits.fz")][0]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        TB.load_ref_input(red)


def test_too_few_images(tmp_path):
    """An empty tree: too few images in both packages."""
    s = dict(NP.COADD_SETTINGS)
    got = TB.build_reference(DataTree(str(tmp_path), "ML1"), "ML1", 42, "q",
                             TB.BuildRefSettings(**s), device="cpu")
    want = JB.build_reference(JTree(str(tmp_path), "ML1"), "ML1", 42, "q",
                              JB.BuildRefSettings(**s))
    assert got == want == ("too_few_images", {"nsel": 0})
