"""The port's per-frame driver against the JAX package's: one TINY night
(3 bias, 3 flat and 2 object frames of field 42, ``create_ref=True``)
reduced file to file by both ``Pipeline``s, the port's with
``device="cpu"``, in two copies of the same raw tree.  The first visit
is adopted as the field reference; the second carries one extra point
source, the transient, and is subtracted against it.  The night and
the comparisons are in ``night_parity.py``, which ``chip_smoke.py``
shares to hold the port on the card against the port on the CPU.

What is held, product by product:
- statuses, product basenames, header keyword sets and ``*-P`` flags:
  equal; every integer, boolean and string keyword equal;
- magnitudes (PC-ZP, PC-ZPSTD, LIMMAG) within 1e-3 mag, but for one
  calibration star at the zeropoint's clip edge (``clip_edge``: the
  card and the CPU kept 12 and 13 stars of one TINY frame);
- other float keywords within 2e-3 of their value (measured: up to
  5e-4, the astrometric CD matrix and the PSF chi2), plus, for those in e-
  (overscan levels and read noise, saturation, background), the pixel
  atol below: a channel's read noise is a standard deviation of the
  overscan through the float32 fit at the ~1.6e4 e- level, and
  differed by 0.04 e- on a flat;
- masks (``_mask.fits.fz``, the reference's too): bit for bit;
- decoded float images: the Rice coding quantises each tile to a step
  ZSCALE, so two inputs that differ by d decode up to d plus one step
  apart.  The calibrated frames' d is the pixel atol of
  ``test_torch_reduce.py`` (1e-3 e- + 1e-5 of the largest overscan
  level), plus, on the object frames, the pixel times the relative
  difference of the two master flats, which are stacks of flats read
  back from their own Rice products; the master flat itself differs by
  its inputs' relative step; D and Scorr by the tolerances of
  ``test_torch_science.py``;
- catalogs: same rows, integer columns exact, positions within 1e-3
  px (``test_torch_reduce.py``'s centroid floor), fluxes within 1e-4
  of themselves plus a tenth of their own error (signal-to-noise
  ratios within 0.1), magnitudes within a tenth of their error and
  their errors as moved by that, shape columns within 1e-3 of
  themselves;
- transients: ``T-NTRANS`` equal and the peak pixels equal but for
  ``peak_ties``, the rest of the catalog at the Scorr and flux
  tolerances of ``test_torch_science.py``.
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
from blackbox_tpu.pipeline.driver import Pipeline as JPipeline  # noqa: E402
from blackbox_tpu_torch.config.defaults import ReductionSettings  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.orchestration.paths import DataTree  # noqa: E402
from blackbox_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from blackbox_tpu_torch.pipeline.reduce import ReduceContext  # noqa: E402


@pytest.fixture(scope="module")
def nights(tmp_path_factory):
    """The night through both packages: {"jax": run, "port": run,
    "files": raw paths relative to a root}, each run (results, root)."""
    base = str(tmp_path_factory.mktemp("nights"))
    raw_root = os.path.join(base, "raw")
    files, stars = NP.tiny_night(raw_root)
    query = NP.ref_catalog(stars, TINY.red_shape)
    js = JSettings(geometry=JTINY, pixscale=NP.PIXSCALE, create_ref=True)
    jctx = _ctx(js)
    out = {"files": [os.path.relpath(f, raw_root) for f in files]}
    for side in ("jax", "port"):
        root = os.path.join(base, side)
        shutil.copytree(raw_root, root)
        if side == "jax":
            pipe = JPipeline(JTree(root, "ML1"), "ML1", js, jctx,
                             ref_catalog=query)
        else:
            s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                                  create_ref=True)
            ctx = ReduceContext.from_reference(jctx)
            assert ctx == NP.tiny_ctx(s)
            pipe = tdriver.Pipeline(DataTree(root, "ML1"), "ML1", s, ctx,
                                    ref_catalog=query, device="cpu")
        out[side] = ([pipe.process_file(os.path.join(root, f))
                      for f in out["files"]], root)
    out["port_pipe"] = pipe
    return out


def _level(nights):
    return NP.overscan_level(nights["jax"])


def test_statuses_and_products(nights):
    NP.check_statuses(nights["port"], nights["jax"])


def test_headers_keywords_flags_and_values(nights):
    NP.check_headers(nights["port"], nights["jax"], _level(nights))


def test_flags_of_the_night(nights):
    """The flags a night must end with, in the port's run: masters
    built and applied, astrometry, photometric calibration, the first
    visit adopted as the reference, the second visit subtracted."""
    res = nights["port"][0]
    for r in res[6:]:
        h = r.header
        for k in ("MFLAT-P", "S-P", "A-P", "PC-P", "PSF-P", "TRANS-P"):
            assert h[k] is True, k
    assert res[6].header["REF-NEW"] is True
    assert "REF-NEW" not in res[7].header
    assert int(res[7].header["T-NTRANS"]) >= 1


def test_masks_bit_for_bit(nights):
    # the two visits' masks and the reference's
    assert NP.check_masks(nights["port"], nights["jax"]) == 3


def test_master_flat(nights):
    NP.check_master_flat(nights["port"], nights["jax"])


def test_reduced_images(nights):
    # bias, flat, the two visits, the reference's image and STD map
    assert NP.check_images(nights["port"], nights["jax"],
                           _level(nights)) == 3 + 3 + 2 + 2


def test_difference_images(nights):
    NP.check_difference_images(nights["port"], nights["jax"])


def test_catalogs(nights):
    rows = NP.check_catalogs(nights["port"], nights["jax"])
    assert len(rows) == 3 and min(rows) >= 25


def test_transient_catalog(nights):
    x, y = NP.check_transients(nights["port"], nights["jax"])
    tx, ty, _ = NP.TRANS
    assert np.hypot(x - tx, y - ty).min() < 2.0


def test_skip_on_reprocess(nights):
    """tests/test_driver.py's skip contract on the port: a finished
    frame is skipped, with or without the transient stage."""
    pipe, root = nights["port_pipe"], nights["port"][1]
    assert pipe.process_file(os.path.join(
        root, nights["files"][0])).status == "skipped"
    assert pipe.process_file(os.path.join(root, nights["files"][-1]),
                             trans_extract=False).status == "skipped"


def test_rejected_header(nights, tmp_path):
    from blackbox_tpu_torch.io.fits import Header, write_image
    bad = str(tmp_path / "bad.fits")
    write_image(bad, np.zeros((8, 8), np.uint16), Header())
    r = nights["port_pipe"].process_file(bad)
    assert r.status == "rejected"
    assert "missing required keyword" in r.error


def test_img_reduce_only_and_resume(tmp_path):
    """tests/test_driver.py's resume contract on the port:
    cat_extract=False publishes the image products and no catalog; the
    resume writes the catalog from the published products (RED-REUSED)
    without re-encoding them."""
    from blackbox_tpu_torch.synth.observation import night_of_observations
    rng = np.random.default_rng(33)
    files, truths, tree = night_of_observations(
        str(tmp_path), TINY, rng, date="20260310", nbias=3, nflat=3,
        nsci=1, nstars=30, ncosmics=4, trail=False, nsat=0, sky_e=300.0,
        ra_deg=NP.RA0, dec_deg=NP.DEC0)
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE)
    pipe = tdriver.Pipeline(
        tree, "ML1", s, NP.tiny_ctx(s), subtract_refs=False, device="cpu",
        ref_catalog=NP.ref_catalog(truths[-1].stars, TINY.red_shape))
    for f in files[:-1]:
        assert pipe.process_file(f).status == "reduced"
    r = pipe.process_file(files[-1], cat_extract=False, trans_extract=False)
    assert r.status == "reduced", r.error
    assert not any(p.endswith("_red_cat.fits") for p in r.products)
    red = next(p for p in r.products if p.endswith("_red.fits.fz"))
    cat = red.replace("_red.fits.fz", "_red_cat.fits")
    assert not os.path.exists(cat)
    red_bytes = open(red, "rb").read()
    r2 = pipe.process_file(files[-1], trans_extract=False)
    assert r2.status == "reduced", r2.error
    assert os.path.exists(cat) and r2.header.get("RED-REUSED") is True
    assert r2.header["S-P"] is True and r2.header["A-P"] is True
    assert open(red, "rb").read() == red_bytes


def test_psf_products_round_trip(nights):
    """Each visit's _psf.fits reads back through the port's read_psf as
    the JAX package's read_psf reads the same file, and the port's
    write_psf/read_psf round trip is exact."""
    import dataclasses
    import torch
    from blackbox_tpu.io.psffits import read_psf as jread
    from blackbox_tpu_torch.io.psffits import read_psf, write_psf
    found = NP.pairs(nights["port"], nights["jax"], "_psf.fits")
    assert len(found) == 2
    for _, pp in found:
        got, want = read_psf(pp, device="cpu"), jread(pp)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "poldeg":
                assert a == b
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        again = os.path.join(os.path.dirname(pp), "again_psf.fits")
        write_psf(again, got)
        back = read_psf(again, device="cpu")
        for f in dataclasses.fields(got):
            a, b = getattr(back, f.name), getattr(got, f.name)
            assert a == b if f.name == "poldeg" else torch.equal(a, b)
        os.remove(again)


def test_clip_edge_allowance():
    """One calibration star more or less moves the zeropoint by its
    standard error and its scatter by one star's weight; two are
    refused, and equal counts allow nothing."""
    from blackbox_tpu_torch.io.fits import Header
    a, b = Header(), Header()
    for h, n, std in ((a, 12, 0.0067), (b, 13, 0.0082)):
        h["PC-NCAL"], h["PC-ZPSTD"] = n, std
    dzp, dstd = NP.clip_edge(a, b)
    assert dzp == pytest.approx(0.0082 / np.sqrt(12))
    assert dstd == pytest.approx(6.25 / 24)
    assert NP.clip_edge(a, a) == (0.0, 0.0)
    b["PC-NCAL"] = 14
    with pytest.raises(AssertionError):
        NP.clip_edge(a, b)


def test_quicklooks(nights):
    """Every quicklook the port published opens as an image of the
    frame's shape (the JPEGs) or as the transient thumbnail grid."""
    from PIL import Image
    H, W = TINY.red_shape
    shots = [p for r in nights["port"][0] for p in r.products
             if p.endswith((".jpg", ".png"))]
    assert sum(p.endswith(".jpg") for p in shots) == 6 + 2
    assert sum(p.endswith("_trans.png") for p in shots) == 1
    for p in shots:
        with Image.open(p) as im:
            im.load()
            if p.endswith(".jpg"):
                assert im.size == (W, H), p
            else:
                assert im.size[0] > 0 and im.size[1] > 0


def test_timing_spans(nights):
    """Each frame records its wall time and the synchronised device
    spans: calibration (+ extraction) always, the subtraction on the
    second visit only."""
    for i, r in enumerate(nights["port"][0]):
        t = r.timing
        assert t["wall"] > 0 and 0 < t[tdriver.SPAN_CALIB] <= t["wall"]
        assert (tdriver.SPAN_SUBTRACT in t) == (i == 7)


UNPORTED = {
    "sso_elements": ("sso", dict(sso_elements=[object()])),
    "mpcorb_file": ("sso", dict(settings={"mpcorb_file": "MPCORB.DAT"})),
    "trailnet_params": ("trailnet", dict(trailnet_params={})),
    "sat_model_path": ("trailnet", dict(settings={
        "use_unet_sat": True, "sat_model_path": "asta.h5"})),
    "vetnet_params": ("vetnet", dict(vetnet_params={})),
    "blind_index": ("blindsolve", dict(blind_index=object())),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_branches_raise(name, tmp_path):
    module, kw = UNPORTED[name]
    kw = dict(kw)
    s = ReductionSettings(geometry=TINY)
    for k, v in kw.pop("settings", {}).items():
        setattr(s, k, v)
    with pytest.raises(NotImplementedError, match=module):
        tdriver.Pipeline(DataTree(str(tmp_path), "ML1"), "ML1", s,
                         device="cpu", **kw)


def test_device_override_raises(tmp_path):
    pipe = tdriver.Pipeline(DataTree(str(tmp_path), "ML1"), "ML1",
                            ReductionSettings(geometry=TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="scheduler"):
        pipe.process_file(str(tmp_path / "x.fits"), device_override={})


def test_pipeline_defaults_to_the_card(nights, tmp_path):
    """Without a device argument the pixel work goes to the card: with
    no CUDA device the frame fails (contained, as every frame error is)
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = str(tmp_path / "t")
    raw = os.path.join(root, nights["files"][0])
    os.makedirs(os.path.dirname(raw))
    shutil.copy(os.path.join(nights["port"][1], nights["files"][0]), raw)
    pipe = tdriver.Pipeline(DataTree(root, "ML1"), "ML1",
                            ReductionSettings(geometry=TINY))
    assert pipe.device.type == "cuda"
    r = pipe.process_file(raw)
    assert r.status == "error" and "CUDA" in r.error.upper(), r.error
