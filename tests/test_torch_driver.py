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

Both pipelines carry known asteroids (``sso_elements``: one that the
ephemeris puts on the transient at the second visit, one elsewhere) and
a blind-solve quad index over the calibration stars (``blind_index``).
After the night a third visit, whose header points half a degree off,
goes through both: the seeded solve fails and the blind solve finds the
frame, with the same flags, match counts and solution in both; the SSO
columns of the transient catalog are equal.  Two more visits carry the
networks: the first with parameters carried across in memory, the
second with the U-Net loaded by both drivers from one file the JAX
package's ``save_params`` wrote (``sat_model_path``).
"""

import dataclasses
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
    out = {"files": [os.path.relpath(f, raw_root) for f in files],
           "stars": stars}
    kw = dict(sso_elements=_sso_elements(files[-1]),
              blind_index=NP.quad_index(stars, TINY.red_shape))
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                          create_ref=True)
    ctx = ReduceContext.from_reference(jctx)
    assert ctx == NP.tiny_ctx(s)

    def make(side, root, settings=None, **extra):
        """A side's Pipeline over ``root``; ``settings`` (a dict) updates
        the night's settings."""
        if side == "jax":
            return JPipeline(JTree(root, "ML1"), "ML1",
                             dataclasses.replace(js, **(settings or {})),
                             jctx, ref_catalog=query, **extra)
        return tdriver.Pipeline(DataTree(root, "ML1"), "ML1",
                                dataclasses.replace(s, **(settings or {})),
                                ctx, ref_catalog=query, device="cpu",
                                **extra)

    for side in ("jax", "port"):
        root = os.path.join(base, side)
        shutil.copytree(raw_root, root)
        pipe = make(side, root, **kw)
        out[side] = ([pipe.process_file(os.path.join(root, f))
                      for f in out["files"]], root)
        out[side + "_pipe"] = pipe
    out["make"] = make
    return out


SSO_HIT = "K26A01B"


def _sso_elements(visit):
    """An asteroid on the transient at the visit's mid-exposure (the
    driver's MJD-OBS), as seen from the ML1 site, and one 20 arcmin
    away."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.config.base import get_par
    from blackbox_tpu_torch.io.fits import read_fits
    h = read_fits(visit)[0][1]
    mjd = round(iso2mjd(str(h["DATE-OBS"]))
                + float(h["EXPTIME"]) / 172800.0, 8)
    site = get_par(ReductionSettings().site, "ML1")
    ra, dec = TanWCS.simple(NP.RA0, NP.DEC0, NP.PIXSCALE,
                            TINY.red_shape).pix2sky(*NP.TRANS[:2])
    return [NP.sso_elements_at(float(ra), float(dec), mjd, site, SSO_HIT),
            NP.sso_elements_at(float(ra) + 0.3, float(dec) - 0.2, mjd, site,
                               "K26A02C")]


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


# the network branches: each is taken as the JAX driver takes it
# (attribute, value it must end with); a sat_model_path that cannot be
# read is logged and leaves the U-Net off, as in the JAX package
NETWORK_BRANCHES = {
    "trailnet_params": (dict(trailnet_params={"w": 1}), "trailnet_params",
                        {"w": 1}),
    "sat_model_path": (dict(settings={
        "use_unet_sat": True, "sat_model_path": "asta.h5"}),
        "trailnet_params", None),
    "vetnet_params": (dict(vetnet_params={"w": 2}), "vetnet_params",
                      {"w": 2}),
}


@pytest.mark.parametrize("name", sorted(NETWORK_BRANCHES))
def test_network_branches_run(name, tmp_path):
    kw, attr, want = NETWORK_BRANCHES[name]
    kw = dict(kw)
    s = ReductionSettings(geometry=TINY)
    for k, v in kw.pop("settings", {}).items():
        setattr(s, k, v)
    pipe = tdriver.Pipeline(DataTree(str(tmp_path), "ML1"), "ML1", s,
                            device="cpu", **kw)
    assert getattr(pipe, attr) == want


def test_device_override_publishes_the_batched_result(nights, tmp_path):
    """process_file(device_override=...) (the batched runner's
    precomputed device work): the first visit, reduced
    again in a copy of the night's tree from the outputs of the port's
    own calibrate + extract, publishes the same header and mask as the
    night's per-frame run, and the override's image is what it
    writes."""
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.orchestration.paths import night_date
    from blackbox_tpu_torch.pipeline.reduce import (calibrate_detector,
                                                    extract_catalog)
    root = str(tmp_path / "copy")
    shutil.copytree(nights["port"][1], root)
    rel = nights["files"][6]
    want = nights["port"][0][6]
    pipe = nights["make"]("port", root)
    raw, _ = tdriver.read_fits(os.path.join(root, rel))[0]
    chan, osv, osh = pipe.geom.split_raw(pipe._upload_raw(raw))
    d = night_date(float(want.header["MJD-OBS"]), pipe.site[1])
    mf, _ = pipe.masters.ensure_master("flat", d, pipe.geom, filt="q")
    mflat = pipe.geom.disassemble(torch.as_tensor(np.asarray(mf,
                                                             np.float32)))
    with torch.inference_mode():
        sci, mask, stats = calibrate_detector(
            pipe.ctx, chan, osv, osh, None, mflat, None, None, None)
        ext = extract_catalog(pipe.ctx, sci, mask)
    res = pipe.process_file(os.path.join(root, rel), force=True,
                            device_override={"sci": sci, "mask": mask,
                                             "stats": stats, "ext": ext})
    assert res.status == want.status == "reduced", res.error
    assert res.header["MFLAT-P"] is True
    for k in want.header.keys():
        if k.endswith("-P"):
            assert res.header[k] == want.header[k], k
    for p in res.products:
        if p.endswith("_mask.fits.fz"):
            q = os.path.join(nights["port"][1], os.path.relpath(p, root))
            assert np.array_equal(read_rice(p)[0], read_rice(q)[0])


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


def test_sso_columns_match_jax(nights):
    """The second visit's transients carry the SSO columns in both
    packages, equal, with the asteroid on the transient matched."""
    for side in ("port", "jax"):
        h = nights[side][0][-1].header
        assert h["SSO-P"] is True and h["N-SSO"] == 1, side
    (tb, ta), = NP.pairs(nights["port"], nights["jax"], "_red_trans.fits")
    ca, cb = NP.table(ta), NP.table(tb)
    for k in ("SSO_DESIG", "SSO_SEP", "SSO_MAG"):
        x, y = np.asarray(ca[k]), np.asarray(cb[k])
        if k == "SSO_DESIG":
            assert list(x) == list(y), k
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-3,
                                       err_msg=k)
    hit = [i for i, d in enumerate(ca["SSO_DESIG"]) if d.strip() == SSO_HIT]
    assert len(hit) == 1
    x = np.asarray(ca["X_PEAK"])[hit[0]] - 1
    y = np.asarray(ca["Y_PEAK"])[hit[0]] - 1
    assert np.hypot(x - NP.TRANS[0], y - NP.TRANS[1]) < 2.0
    assert float(np.asarray(ca["SSO_SEP"])[hit[0]]) < 2.0


def test_mpcorb_file_loads_the_elements(tmp_path):
    """settings.mpcorb_file is parsed into the pipeline's elements, as
    in the JAX package; an unreadable file turns the matching off."""
    from blackbox_tpu.pipeline.driver import Pipeline as JP
    from test_sso import _mpcorb_line
    line = _mpcorb_line()
    p = tmp_path / "MPCORB.DAT"
    p.write_text(line + "\n")
    for path, n_el in ((str(p), 1), (str(tmp_path / "missing.DAT"), 0)):
        s = ReductionSettings(geometry=TINY)
        s.mpcorb_file = path
        got = tdriver.Pipeline(DataTree(str(tmp_path), "ML1"), "ML1", s,
                               device="cpu").sso_elements
        js = JSettings(geometry=JTINY)
        js.mpcorb_file = path
        want = JP(JTree(str(tmp_path), "ML1"), "ML1", js).sso_elements
        assert len(got) == len(want) == n_el
        assert [e.designation for e in got] == \
            [e.designation for e in want]


def test_lost_pointing_blind_solve(nights):
    """A visit whose header points half a degree off: the seeded solve
    fails, the blind solve over the quad index finds the frame
    (A-BLIND), and the frame is calibrated and subtracted as the night's
    second visit is.  Both packages give the same flags, match counts
    and solution."""
    runs = {}
    for side in ("port", "jax"):
        root = nights[side][1]
        path = NP.lost_pointing_visit(root, nights["stars"])
        runs[side] = ([nights[side + "_pipe"].process_file(path)], root)
    NP.check_statuses(runs["port"], runs["jax"])
    h, hj = (runs[s][0][0].header for s in ("port", "jax"))
    assert set(h.keys()) == set(hj.keys())
    assert all(h[k] == hj[k] for k in h.keys() if k.endswith("-P"))
    for k in ("A-BLIND", "A-NAST", "PC-NCAL", "T-NTRANS", "QC-FLAG"):
        assert h[k] == hj[k], k
    # the solution: the reference point within 1e-3 px, the CD matrix,
    # the rms and the zeropoint as the night's keywords
    for k in ("CRVAL1", "CRVAL2"):
        assert abs(h[k] - hj[k]) <= 1e-3 * NP.PIXSCALE / 3600, k
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2", "A-RMS"):
        assert abs(h[k] - hj[k]) <= NP.FLOAT_RTOL * abs(hj[k]), k
    assert abs(h["PC-ZP"] - hj["PC-ZP"]) <= 1e-3
    assert h["A-BLIND"] is True and h["A-P"] is True, dict(h.items())
    assert h["PC-P"] is True and h["TRANS-P"] is True
    # the blind WCS puts the frame where the stars are, not where the
    # header pointed
    from blackbox_tpu_torch.astro.wcs import TanWCS
    wcs = TanWCS.from_header(h)
    ra, dec = wcs.pix2sky(*(np.asarray(v) for v in nights["stars"][:, :2].T))
    want = TanWCS.simple(NP.RA0, NP.DEC0, NP.PIXSCALE, TINY.red_shape)
    ra0, dec0 = want.pix2sky(*(np.asarray(v)
                               for v in nights["stars"][:, :2].T))
    d = np.hypot((ra - ra0) * np.cos(np.radians(NP.DEC0)), dec - dec0)
    assert np.median(d) * 3600 < 1.0


# ------------------------------------------------ the networks' branches

@pytest.fixture(scope="module")
def net_visit(nights):
    """A further visit of the night's field with the transient, after
    the night, through both packages' pipelines with the trail U-Net and
    the real/bogus network: the JAX package's flax parameters (its
    init_params, the U-Net's output layer scaled and shifted so that a
    few per cent of the binned frame passes the threshold) carried
    across with from_jax_params."""
    import jax
    from test_torch_models import _sharp_params
    from blackbox_tpu.models import vetnet as jvet
    from blackbox_tpu_torch.io.fits import read_fits
    from blackbox_tpu_torch.models import vetnet as tvet
    from blackbox_tpu_torch.models.trailnet import from_jax_params
    runs = {}
    for side, mod in (("jax", jvet), ("port", tvet)):
        root = nights[side][1]
        path = NP.net_visit(root, nights["stars"])
        if side == "jax":
            raw = read_fits(path)[0][0].astype(np.float32)
            chan, _, _ = TINY.split_raw(raw)
            unet = _sharp_params(TINY.assemble(chan), key=2, frac=0.08)
            vet = jvet.init_params(jax.random.PRNGKey(4))
            runs["vet_params"] = vet
            runs["unet_params"] = unet
        else:
            unet, vet = from_jax_params(unet), from_jax_params(vet)
        pipe = nights["make"](side, root, trailnet_params=unet,
                              vetnet_params=vet)
        # the maps and candidates the driver scores, kept
        seen = []
        score = mod.score_transients

        def keep(*args, score=score, seen=seen):
            seen.append([_host_array(a) for a in args[1:]])
            return score(*args)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "score_transients", keep)
            runs[side] = ([pipe.process_file(path)], root)
        runs[side + "_scored"] = seen
    return runs


def _host_array(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_networks_flags_and_masks(net_visit):
    """ASTA-P and MC-P set in both, the same flags, keywords and
    masks, SATELLITE bits included, with the U-Net's mask in them."""
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.rice import read_rice
    a, b = net_visit["port"], net_visit["jax"]
    NP.check_statuses(a, b)
    for r in (a[0][0], b[0][0]):
        assert r.header["ASTA-P"] is True and r.header["MC-P"] is True
        assert r.header["TRANS-P"] is True
    assert a[0][0].header["MC-MED"] == b[0][0].header["MC-MED"]
    NP.check_headers(a, b, NP.overscan_level(b))
    (pb, pa), = [p for p in NP.pairs(a, b, "_mask.fits.fz")
                 if "235500" in p[0]]
    x, _ = read_rice(pa)
    y, _ = read_rice(pb)
    assert np.array_equal(x, y)
    assert int(np.sum((x & maskbits.SATELLITE) != 0)) > 0


def test_networks_class_real(net_visit):
    """CLASS_REAL, the real/bogus column (the only one the network
    adds): the port's column agrees to 1e-5 with the JAX package's
    network on the maps and candidates the port's driver scored.
    Between the two drivers the maps themselves differ at the
    subtraction's parity tolerances (Scorr to 5%), so there the column
    agrees to 1e-3."""
    import jax.numpy as jnp
    from blackbox_tpu.models.vetnet import score_transients
    a, b = net_visit["port"], net_visit["jax"]
    (tb, ta), = [p for p in NP.pairs(a, b, "_red_trans.fits")
                 if "235500" in p[0]]
    ca, cb = NP.table(ta), NP.table(tb)
    assert list(ca) == list(cb) and "CLASS_REAL" in ca
    x, y = np.asarray(ca["CLASS_REAL"]), np.asarray(cb["CLASS_REAL"])
    assert len(x) >= 1 and np.all((x >= 0) & (x <= 1))
    (maps,) = net_visit["port_scored"]
    want = score_transients(net_visit["vet_params"],
                            *(jnp.asarray(m) for m in maps))
    np.testing.assert_allclose(x, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x, y, rtol=0, atol=1e-3)


def test_sat_model_path_keras_route(tmp_path):
    """A sat_model_path ending in .h5 goes through
    convert_keras_weights, as in the JAX package; any other path
    through load_params: the port's own file, its earlier torch.save
    state dict, and the flax file the JAX package's save_params writes,
    which gives the parameters from_jax_params carries across."""
    pytest.importorskip("h5py")
    import jax
    from test_torch_models import _keras_file
    from blackbox_tpu.models.trailnet import init_params as jinit
    from blackbox_tpu.models.trailnet import save_params as jsave
    from blackbox_tpu_torch.models import trailnet as TT
    h5p = _keras_file(str(tmp_path / "asta.h5"),
                      jinit(jax.random.PRNGKey(1), tile=32))
    pt = str(tmp_path / "unet.pt")
    TT.save_params(pt, TT.init_params(torch.Generator().manual_seed(0)))
    old = str(tmp_path / "unet_torch_save.pt")
    torch.save(TT.init_params(torch.Generator().manual_seed(1)), old)
    jparams = jinit(jax.random.PRNGKey(2), tile=32)
    flax_file = str(tmp_path / "unet.msgpack")
    jsave(flax_file, jparams)
    for path, want in ((h5p, TT.convert_keras_weights(h5p)),
                       (pt, TT.load_params(pt)),
                       (old, torch.load(old, weights_only=True)),
                       (flax_file, TT.from_jax_params(jparams))):
        s = ReductionSettings(geometry=TINY)
        s.use_unet_sat, s.sat_model_path = True, path
        got = tdriver.Pipeline(DataTree(str(tmp_path), "ML1"), "ML1", s,
                               device="cpu").trailnet_params
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def file_visit(nights, net_visit, tmp_path_factory):
    """A further visit of the night's field, at 23:58 with net_visit's
    pixels, through both packages' pipelines with ``use_unet_sat`` and
    ``sat_model_path`` naming one file: the U-Net parameters of
    net_visit, written by the JAX package's ``save_params``."""
    from blackbox_tpu.models.trailnet import save_params as jsave
    path = str(tmp_path_factory.mktemp("weights") / "unet.msgpack")
    jsave(path, net_visit["unet_params"])
    runs = {"path": path}
    for side in ("jax", "port"):
        root = nights[side][1]
        visit = NP.net_visit(root, nights["stars"], at="23:58:00")
        pipe = nights["make"](side, root, settings=dict(
            use_unet_sat=True, sat_model_path=path))
        assert pipe.trailnet_params is not None
        runs[side] = ([pipe.process_file(visit)], root)
        runs[side + "_pipe"] = pipe
    return runs


def _satellite(run, stamp):
    from blackbox_tpu_torch.core import maskbits
    from blackbox_tpu_torch.io.rice import read_rice
    (path,) = [q for q in run[0][0].products
               if q.endswith("_mask.fits.fz") and stamp in q]
    return (read_rice(path)[0] & maskbits.SATELLITE) != 0


def test_sat_model_path_night(file_visit, net_visit):
    """Both drivers run the U-Net from the JAX-written file: ASTA-P set
    in both, the SATELLITE bits equal but for pixels on the mask's edge
    (``mask_edge_flips``), and the port's equal, bit for bit, to those
    of the same pixels with the parameters carried across in memory
    (net_visit's 23:55 visit)."""
    from blackbox_tpu_torch.models.trailnet import from_jax_params
    a, b = file_visit["port"], file_visit["jax"]
    NP.check_statuses(a, b)
    for r in (a[0][0], b[0][0]):
        assert r.header["ASTA-P"] is True
    loaded = file_visit["port_pipe"].trailnet_params
    carried = from_jax_params(net_visit["unet_params"])
    assert all(torch.equal(loaded[k], carried[k]) for k in carried)
    got, want = _satellite(a, "235800"), _satellite(b, "235800")
    assert got.sum() > 0
    NP.mask_edge_flips(got, want)
    assert np.array_equal(got, _satellite(net_visit["port"], "235500"))
