"""The driver's optional calibration branches through both packages on
the CPU: every check of ``tests/test_wiring.py`` (every settings knob
must have an observable effect), held between the JAX package's
``Pipeline`` and the port's (``device="cpu"``) on the same inputs.

One night carries the knobs (``night_parity.tiny_knob_night``: the
TINY night of ``tests/test_torch_driver.py`` plus three darks, a static
bad-pixel mask and a constant 2 % non-linearity correction named
relative to ``cal_dir``, ``create_mdark``, ``create_ref`` and the field
grid).  Each package reduces it once, in its own copy of the raw tree
(``sides``).  Then the same Pipeline, its calibration stars taken away,
reduces the first visit's raw frame again under a later name
(``PLAIN``): first with the QC engine sabotaged (the contract gate),
then as is (the default zeropoint), then, with the catalog deleted,
with a published header failing the contract once and a
``device_override`` whose image is the frame's own plus OFFSET (the
recursion to raw must publish the override's pixels).  The port
reduces the frame once more without the correction (``BARE``).  Last,
both packages resume the second visit (its catalog deleted, twice) in
two copies of the JAX package's reduced tree, from the same published
image.  The night is held by ``night_parity``'s comparisons at their
tolerances; the other tolerances are stated in each test.  The master
store, the spline converter and the context plumbing need no night.
"""

import glob
import os
import pickle
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
from blackbox_tpu.pipeline import driver as jdriver  # noqa: E402
from blackbox_tpu.pipeline import headers as jheaders  # noqa: E402
from blackbox_tpu.pipeline.reduce import ReduceContext as JContext  # noqa: E402
from blackbox_tpu_torch.config.defaults import ReductionSettings  # noqa: E402
from blackbox_tpu_torch.core import maskbits  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.io.fits import Header  # noqa: E402
from blackbox_tpu_torch.io.rice import read_rice, write_rice  # noqa: E402
from blackbox_tpu_torch.orchestration.paths import DataTree  # noqa: E402
from blackbox_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from blackbox_tpu_torch.pipeline import headers as theaders  # noqa: E402
from blackbox_tpu_torch.pipeline.reduce import ReduceContext  # noqa: E402

SIDES = ("jax", "port")
DRIVER = {"jax": jdriver, "port": tdriver}
HEADERS = {"jax": jheaders, "port": theaders}
OFFSET = 25.0           # e-, the override's shift of the calibrated frame
PLAIN = f"ML1_{NP.DATE}_235900.fits"
BARE = f"ML1_{NP.DATE}_235800.fits"


def _make(side, root, settings, **kw):
    """A side's Pipeline over ``root`` with ``settings`` (a dict) on top
    of the TINY geometry and pixel scale, its context the twin
    ``test_driver._ctx`` / ``night_parity.tiny_ctx`` of those
    settings."""
    if side == "jax":
        s = JSettings(geometry=JTINY, pixscale=NP.PIXSCALE, **settings)
        return jdriver.Pipeline(JTree(root, "ML1"), "ML1", s, _ctx(s), **kw)
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE, **settings)
    return tdriver.Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                            device="cpu", **kw)


def _product(r, suffix):
    p, = (p for p in r.products if p.endswith(suffix))
    return p


def _run_plain(side, root, out):
    """The first visit's raw frame again as PLAIN, through the night's
    Pipeline without its calibration stars: the contract gate, the
    plain reduction and the recursion, into ``out``; on the port, also
    as BARE, without the non-linearity correction."""
    raw_dir = DataTree(root, "ML1").raw_dir(NP.DATE)
    plain = os.path.join(raw_dir, PLAIN)
    shutil.copy(os.path.join(root, out["files"][-2]), plain)
    pipe = out["pipe"]
    pipe.ref_catalog = None
    drv, base = DRIVER[side], PLAIN[:-len(".fits")]
    with pytest.MonkeyPatch.context() as mp:
        real_qc = drv.run_qc_check

        def sabotage(h, *a, **kw):
            flag = real_qc(h, *a, **kw)
            if kw.get("check_key_type") == "full":
                del h["NOBJECTS"]           # required by the contract
            return flag
        mp.setattr(drv, "run_qc_check", sabotage)
        out["contract"] = pipe.process_file(plain, trans_extract=False)
    out["contract_cats"] = glob.glob(os.path.join(
        root, "**", base + "_red_cat.fits"), recursive=True)

    seen = []
    reduce_sci = pipe._reduce_sci

    def keep(*args):
        seen.append(reduce_sci(*args))
        return seen[-1]
    pipe._reduce_sci = keep
    out["plain"] = pipe.process_file(plain, trans_extract=False)
    pipe._reduce_sci = reduce_sci
    red = _product(out["plain"], "_red.fits.fz")
    out["plain_red"] = NP.decode(red)

    # the repaired recursion: the published header fails the contract
    # once on the reuse path, and the frame goes back to raw with the
    # batched runner's device work
    sci, mask, stats, _ = seen[0]
    os.remove(_product(out["plain"], "_red_cat.fits"))
    calls = []
    hdr = HEADERS[side]
    real_verify = hdr.verify_header

    def fail_once(h, *a, **kw):
        calls.append(kw)
        return ["NOBJECTS forced missing"] if len(calls) == 1 \
            else real_verify(h, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hdr, "verify_header", fail_once)
        out["override"] = pipe.process_file(
            plain, trans_extract=False,
            device_override={"sci": sci + OFFSET, "mask": mask,
                             "stats": stats})
    out["verify_calls"] = len(calls)
    out["override_red"] = NP.decode(red)
    if side == "port":
        bare = os.path.join(raw_dir, BARE)
        shutil.copy(plain, bare)
        out["bare"] = _make(side, root, dict(
            cal_dir=os.path.join(root, NP.CAL_DIR),
            bad_pixel_mask={"q": NP.BPM_FILE})).process_file(
                bare, trans_extract=False)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """{side: {"run": (results, root), "resumes": [...], "pipe": the
    night's Pipeline, "contract", "plain", "override": FrameResults,
    ...}} for both packages, each in its own copy of one raw tree."""
    base = str(tmp_path_factory.mktemp("knobs"))
    raw_root = os.path.join(base, "raw")
    files, stars = NP.tiny_knob_night(raw_root)
    files = [os.path.relpath(f, raw_root) for f in files]
    query = NP.ref_catalog(stars, TINY.red_shape)
    out = {}
    for side in SIDES:
        root = os.path.join(base, side)
        shutil.copytree(raw_root, root)
        settings = dict(create_ref=True, **NP.knob_settings(root))
        pipe = _make(side, root, settings, ref_catalog=query,
                     field_grid=NP.FIELD_GRID)
        run = ([pipe.process_file(os.path.join(root, f)) for f in files],
               root)
        out[side] = dict(run=run, pipe=pipe, files=files)
        _run_plain(side, root, out[side])
    # the resume, in two copies of the JAX package's reduced night: both
    # packages extract again from the same published image
    for side in SIDES:
        root = os.path.join(base, "resume_" + side)
        shutil.copytree(out["jax"]["run"][1], root)
        pipe = _make(side, root, dict(create_ref=True,
                                      **NP.knob_settings(root)),
                     ref_catalog=query, field_grid=NP.FIELD_GRID)
        out[side]["resumes"] = NP.resume(pipe, os.path.join(root, files[-1]))
        out[side]["resume_pipe"] = pipe
    return out


def _level(sides):
    return NP.overscan_level(sides["jax"]["run"])


def test_contexts_are_twins(sides):
    """Both packages reduce with the same context, the correction on."""
    s = sides["jax"]["pipe"]
    assert ReduceContext.from_reference(s.ctx) == sides["port"]["pipe"].ctx
    assert s.ctx.correct_nonlin


def test_knob_night_matches_jax(sides):
    """The knob night at night_parity.check_night's tolerances:
    statuses, keywords and flags, masks bit for bit, the master flat,
    images, difference images, catalogs and transients, whose pixel
    counts may differ by their pixels whose |Scorr| lies within the
    Scorr tolerance of the threshold (``threshold_band``: NPIX_ZOGY 14
    and 156 in the port, 13 and 157 in the JAX package); and each
    package's flags
    (night_parity.check_knobs)."""
    for side in SIDES:
        NP.check_knobs(sides[side]["run"], sides[side]["resumes"],
                       TINY.red_shape)
    NP.check_night(sides["port"]["run"], sides["jax"]["run"],
                   _level(sides), npix_band=True)


def test_bad_pixel_mask_wiring(sides):
    """The static mask, named relative to cal_dir: the same BPM-F, the
    BAD bit at every one of its pixels in both packages' masks, and the
    masks bit for bit."""
    rows, cols = NP.bpm_pixels(TINY.red_shape, 40)
    masks = {}
    for side in SIDES:
        for r in sides[side]["run"][0]:
            if str(r.header["IMAGETYP"]).strip() in ("object", "flat"):
                assert r.header["BPM-F"] == NP.BPM_FILE, side
        r = sides[side]["run"][0][-2]
        masks[side] = read_rice(_product(r, "_mask.fits.fz"))[0]
        assert np.all(masks[side].astype(np.uint8)[rows, cols]
                      & maskbits.BAD), side
    assert masks["port"].dtype == masks["jax"].dtype
    assert np.array_equal(masks["port"], masks["jax"])
    assert NP.check_masks(sides["port"]["run"], sides["jax"]["run"]) == 3


def test_cal_dir_resolves_relative_paths(sides, tmp_path):
    """_load_bpm: the mask named relative to cal_dir, and the same file
    by its absolute path, give the same channel stack in both packages,
    with BAD at every one of its pixels and nowhere else."""
    npix = len(set(zip(*NP.bpm_pixels(TINY.red_shape, 40))))
    path = os.path.join(sides["port"]["run"][1], NP.CAL_DIR, NP.BPM_FILE)
    got = {}
    for side in SIDES:
        relative = np.asarray(sides[side]["pipe"]._load_bpm("q"))
        absolute = np.asarray(_make(
            side, str(tmp_path / side),
            dict(bad_pixel_mask={"q": path}))._load_bpm("q"))
        assert np.array_equal(relative, absolute), side
        got[side] = relative
    assert got["port"].shape == TINY.chan_shape
    assert np.array_equal(got["port"], got["jax"])
    assert int(got["port"].sum()) == maskbits.BAD * npix


def test_nonlin_wiring(sides):
    """The .npy correction: NONLIN-P on both packages' frames, S-BKG of
    the first visit equal between packages within the pixel atol, and
    the port's moved by the correction against its run of the same raw
    frame without it (BARE): S-BKG(BARE) / (1 + NONLIN_FRAC) within
    1e-3 of itself (the correction divides every pixel by 1.02 before
    the master bias, which is ~0 e-, and the master flat, which are the
    same in both runs).  The JAX package's S-BKG moves with the port's:
    the correction moves it by 2 % (~6 e-), the packages agree within
    the pixel atol (~0.2 e-)."""
    for side in SIDES:
        for r in sides[side]["run"][0]:
            assert r.header["NONLIN-P"] is True, side
        assert sides[side]["plain"].header["NONLIN-P"] is True, side
    bare = sides["port"]["bare"].header
    assert bare["NONLIN-P"] is False
    knob = {side: float(sides[side]["run"][0][-2].header["S-BKG"])
            for side in SIDES}
    want = float(bare["S-BKG"]) / (1.0 + NP.NONLIN_FRAC)
    assert abs(knob["port"] - want) <= 1e-3 * want, (knob, want)
    assert abs(knob["port"] - knob["jax"]) <= NP.pixel_atol(_level(sides))


def test_nonlin_spline_converter_roundtrip(tmp_path):
    """Reference-format pickled splines: convert_reference_splines gives
    the same coefficients in both packages (rtol 1e-6, atol 1e-9), whose
    polynomial follows the splines within 1e-4 over 0-50k ADU in each
    package's polyval; the .npy converter writes them; and a Pipeline
    named the .pkl loads them, equal between packages."""
    from scipy.interpolate import UnivariateSpline
    import jax.numpy as jnp
    from blackbox_tpu.ops import nonlin as jnl
    from blackbox_tpu.ops.polyfit import polyval_norm as jpolyval
    from blackbox_tpu_torch.ops import nonlin as tnl
    from blackbox_tpu_torch.ops.polyfit import polyval_norm as tpolyval
    C = TINY.n_chan
    adu_k = np.linspace(0.0, 50000.0, 200)
    rng = np.random.default_rng(11)
    splines = []
    for c in range(C):
        a = 0.004 + 0.006 * rng.uniform()
        frac = (a * (adu_k / 5e4) ** 2 - 0.5 * a * (adu_k / 5e4) ** 3
                + 0.001 * np.sin(adu_k / 5e4 * 3.0 + c))
        splines.append(UnivariateSpline(adu_k, frac, k=3, s=0))
    pkl = tmp_path / "nonlin_splines_20200501.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(splines, f)
    got, gerr = tnl.convert_reference_splines(str(pkl))
    want, werr = jnl.convert_reference_splines(str(pkl))
    assert got.shape == want.shape and got.shape[0] == C
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert gerr < 1e-4 and abs(gerr - werr) <= 1e-6 * werr
    adu = np.linspace(0.0, 50000.0, 3000)
    truth = np.stack([s(adu) for s in splines])
    grid = np.tile(adu, (C, 1)).astype(np.float32)
    tv = tpolyval(torch.from_numpy(got), torch.from_numpy(grid),
                  0.0, 50000.0).numpy()
    jv = np.asarray(jpolyval(jnp.asarray(want), jnp.asarray(grid),
                             0.0, 50000.0))
    assert np.max(np.abs(tv - truth)) < 1e-4
    assert np.max(np.abs(jv - truth)) < 1e-4
    for side, mod in (("port", tnl), ("jax", jnl)):
        npy = tmp_path / f"nonlin_{side}.npy"
        mod.convert_reference_splines_to_npy(str(pkl), str(npy))
        np.testing.assert_allclose(np.load(npy), want, rtol=1e-6, atol=1e-9)
    coeffs = {side: _make(side, str(tmp_path / side), dict(
        correct_nonlin=True, nonlin_corr_file=str(pkl))).nonlin_coeffs
        for side in SIDES}
    assert coeffs["port"].shape == (C, want.shape[1])
    np.testing.assert_allclose(coeffs["port"], coeffs["jax"], rtol=1e-6,
                               atol=1e-9)


def test_master_dark_wiring(sides):
    """create_mdark: three darks make the night's master dark in both
    packages, NDARK 3; MDMEAN (written to 4 decimals) equal to one unit
    of its last digit, and at DARK_RATE / (1 + NONLIN_FRAC) within 2 %
    (the darks are corrected too; the mean of 42240 pixels of ~0.2 e-/s
    noise is good to 1e-3 e-/s); the master's pixels as built, at rtol
    1e-5 plus, in e-/s, half the largest quantisation step of each
    package's inputs and the pixel atol.  The store stacks the darks'
    published Rice products: each decodes within half its step (ZSCALE)
    of a calibrated pixel, the two packages' calibrated pixels agree
    within the pixel atol, and a median of three moves no further than
    its inputs."""
    got = {}
    for side in SIDES:
        pipe = sides[side]["pipe"]
        assert pipe.masters.find("dark", NP.DATE) is not None, side
        data, h = pipe.masters.ensure_master("dark", NP.DATE, pipe.geom)
        assert int(h["NDARK"]) == 3, side
        got[side] = (np.asarray(data, np.float64), float(h["MDMEAN"]))
    want = NP.DARK_RATE / (1.0 + NP.NONLIN_FRAC)
    assert abs(got["port"][1] - want) <= 0.02 * want, got["port"][1]
    assert abs(got["port"][1] - got["jax"][1]) <= 1e-4 + 1e-12
    half = [max(float(NP.decode(_product(r, "_red.fits.fz"))[1].max())
                / 2.0 / float(r.header["EXPTIME"])
                for r in sides[side]["run"][0]
                if str(r.header["IMAGETYP"]).strip() == "dark")
            for side in SIDES]
    atol = sum(half) + NP.pixel_atol(_level(sides)) / 60.0
    x, y = got["port"][0], got["jax"][0]
    assert np.all(np.abs(x - y) <= atol + 1e-5 * np.abs(y)), \
        (float(np.abs(x - y).max()), atol)


def test_radecoff_wiring(sides):
    """field_grid: RADECOFF on every object frame of both packages,
    under 5 arcmin and equal to 1e-6 arcmin."""
    for i, rj in enumerate(sides["jax"]["run"][0]):
        rp = sides["port"]["run"][0][i]
        if str(rj.header["IMAGETYP"]).strip() != "object":
            continue
        x, y = float(rp.header["RADECOFF"]), float(rj.header["RADECOFF"])
        assert y < 5.0 and abs(x - y) <= 1e-6, (i, x, y)


def test_zp_default_fallback(sides):
    """No calibration stars: PC-ZPDEF and LIMMAG from the default
    zeropoint in both packages, LIMMAG equal within 1e-3 mag (the
    magnitude tolerance of night_parity.check_headers)."""
    hj = sides["jax"]["plain"].header
    hp = sides["port"]["plain"].header
    assert hj["PC-ZPDEF"] is True and hp["PC-ZPDEF"] is True
    assert hj.get("PC-P") is False and hp.get("PC-P") is False
    assert abs(float(hp["LIMMAG"]) - float(hj["LIMMAG"])) <= 1e-3


def test_verify_header_blocks_shipping(sides):
    """A product violating the header contract does not ship, in either
    package: status error naming the contract, no catalog."""
    for side in SIDES:
        r = sides[side]["contract"]
        assert r.status == "error", (side, r.status)
        assert "contract" in (r.error or ""), (side, r.error)
        assert not sides[side]["contract_cats"], side


def test_granular_resume_reuses_published_red(sides):
    """A visit missing only its catalog is not calibrated again: both
    resumes take the reuse path (RED-REUSED; the port's look up no
    master) in both packages, with the
    same keywords (check_headers), the rewritten catalog agrees
    between packages (check_catalog_pair), and the port's is the
    extraction of the decoded published image bit for bit
    (check_resumed_catalog)."""
    for side in SIDES:
        for r in sides[side]["resumes"]:
            assert r.status == "reduced", (side, r.error)
            assert r.header.get("RED-REUSED") is True, side
    for r in sides["port"]["resumes"]:
        assert tdriver.SPAN_MASTERS not in r.timing
    level = _level(sides)
    for k in range(2):
        NP.check_headers(([sides["port"]["resumes"][k]], None),
                         ([sides["jax"]["resumes"][k]], None), level)
    cats = [_product(sides[side]["resumes"][-1], "_red_cat.fits")
            for side in SIDES]
    NP.check_catalog_pair(cats[1], cats[0])
    assert NP.check_resumed_catalog(sides["port"]["resume_pipe"], cats[1])


def test_create_ref_adopts_frame(sides):
    """create_ref: the first green visit becomes the field reference
    (REF-NEW) in both packages, and the second is subtracted against
    it, with the same T-NTRANS (its catalog is held in
    test_knob_night_matches_jax)."""
    for side in SIDES:
        res, root = sides[side]["run"]
        assert res[-2].header.get("REF-NEW") is True, side
        assert glob.glob(os.path.join(root, "ML1", "ref", "**",
                                      "*_red.fits.fz"), recursive=True)
        h = res[-1].header
        assert h.get("TRANS-P") is True and h["T-NTRANS"] >= 1, side
    assert (sides["port"]["run"][0][-1].header["T-NTRANS"]
            == sides["jax"]["run"][0][-1].header["T-NTRANS"])


def test_device_override_survives_the_contract_recursion(sides):
    """A reused _red whose header fails the contract goes back to raw
    with the caller's device_override, as the JAX package's driver
    does: both publish the override's image, the plain frame's own plus
    OFFSET, within the two Rice steps of the two products (a fresh
    calibration would publish the plain frame's); and the two packages'
    published images agree within a step plus the pixel atol."""
    level = _level(sides)
    pub = {}
    for side in SIDES:
        r = sides[side]["override"]
        assert r.status == "reduced", (side, r.error)
        assert sides[side]["verify_calls"] >= 2, side
        assert r.header.get("RED-REUSED") is None, side
        (y0, s0), (y1, s1) = sides[side]["plain_red"], \
            sides[side]["override_red"]
        d = np.abs(y1 - y0 - OFFSET)
        assert np.all(d <= s0 + s1 + 1e-3), (side, float(d.max()))
        pub[side] = (y1, s1)
    (x, _), (y, step) = pub["port"], pub["jax"]
    assert np.all(np.abs(x - y) <= step + NP.pixel_atol(level)
                  + 1e-5 * np.abs(y))


def _vetting_tree(root):
    """tests/test_wiring.py's flats: four green morning flats dithered by
    ~20", a red-flagged one and an evening one (seed 42)."""
    rng = np.random.default_rng(42)
    rdir = DataTree(root, "ML1").red_dir("20260401", "flat")
    os.makedirs(rdir, exist_ok=True)
    H, W = TINY.red_shape

    def flat(name, mjd, ra, qc, level):
        h = Header()
        h["IMAGETYP"] = "flat"
        h["FILTER"] = "q"
        h["EXPTIME"] = 3.0
        h["MJD-OBS"] = mjd
        h["RA"] = ra
        h["DEC"] = -30.0
        h["QC-FLAG"] = qc
        write_rice(os.path.join(rdir, name),
                   rng.normal(level, 50.0, (H, W)).astype(np.float32), h)
    for i in range(4):
        flat(f"ML1_f{i}_red.fits.fz", 60771.20 + i * 1e-3,
             150.0 + i * 20.0 / 3600.0, "green", 20000.0)
    flat("ML1_fred_red.fits.fz", 60771.21, 150.0, "red", 99999.0)
    flat("ML1_feve_red.fits.fz", 60771.70, 150.0, "green", 99999.0)


def _stores(root, **policy):
    from blackbox_tpu.orchestration.masterstore import (
        MasterPolicy as JPolicy, MasterStore as JStore)
    from blackbox_tpu_torch.orchestration.masterstore import (
        MasterPolicy, MasterStore)
    return {"jax": JStore(JTree(root, "ML1"), "ML1", JPolicy(**policy)),
            "port": MasterStore(DataTree(root, "ML1"), "ML1",
                                MasterPolicy(**policy), device="cpu")}


def test_masterstore_vetting(tmp_path):
    """The red-flagged and the evening flat are left out of the master in
    both packages (the same individual_cals); FLATDITH and N-OFFSET
    equal; the master flats at rtol 1e-5."""
    masters = {}
    for side in SIDES:
        root = str(tmp_path / side)
        _vetting_tree(root)
        store = _stores(root, flat_reject_eve=True, ncal_min=3)[side]
        names = [os.path.basename(p)
                 for p, _ in store.individual_cals("flat", "20260401",
                                                   filt="q")]
        assert sorted(names) == [f"ML1_f{i}_red.fits.fz" for i in range(4)]
        data, mh = store.ensure_master("flat", "20260401",
                                       JTINY if side == "jax" else TINY,
                                       filt="q")
        assert mh["FLATDITH"] is True and int(mh["N-OFFSET"]) >= 3
        masters[side] = (names, np.asarray(data), mh)
    assert masters["port"][0] == masters["jax"][0]
    for k in ("FLATDITH", "N-OFFSET"):
        assert masters["port"][2][k] == masters["jax"][2][k], k
    np.testing.assert_allclose(masters["port"][1], masters["jax"][1],
                               rtol=1e-5)


def test_create_master_gate(tmp_path):
    """create=False: the store only looks up, and builds nothing, in
    both packages; create=True builds the same master bias (atol 1e-5
    e- on a master of ~0 e-)."""
    rng = np.random.default_rng(42)
    rdir = DataTree(str(tmp_path), "ML1").red_dir("20260401", "bias")
    os.makedirs(rdir, exist_ok=True)
    H, W = TINY.red_shape
    for i in range(4):
        h = Header()
        h["IMAGETYP"] = "bias"
        h["QC-FLAG"] = "green"
        h["MJD-OBS"] = 61131.2 + i * 1e-3
        write_rice(os.path.join(rdir, f"ML1_b{i}_red.fits.fz"),
                   rng.normal(0, 5, (H, W)).astype(np.float32), h)
    geom = {"jax": JTINY, "port": TINY}
    built = {}
    for side in SIDES:
        root = str(tmp_path / side)
        shutil.copytree(str(tmp_path / "ML1"), os.path.join(root, "ML1"))
        off = _stores(root, create=False)[side]
        data, _ = off.ensure_master("bias", "20260401", geom[side])
        assert data is None, side
        on = _stores(root, create=True)[side]
        data, _ = on.ensure_master("bias", "20260401", geom[side])
        assert data is not None, side
        built[side] = np.asarray(data)
    np.testing.assert_allclose(built["port"], built["jax"], rtol=1e-5,
                               atol=1e-5)


PLUMBED = {
    "apphot_radii": (dict(apphot_radii=[1.0, 2.0]),
                     lambda c: c.apphot_radii, (3.0, 6.0)),
    "bkg_nsigma": (dict(bkg_nsigma=2.5), lambda c: c.bkg_nsigma, 2.5),
    "sat_bin": (dict(sat_bin=8), lambda c: c.sat_params.bin_factor, 8),
    "size_vignet": (dict(size_vignet=15), lambda c: c.psf_params.size, 15),
    # capped at the 25-px design stamp, and kept odd
    "size_vignet_cap": (dict(size_vignet=99), lambda c: c.psf_params.size,
                        25),
}


@pytest.mark.parametrize("name", sorted(PLUMBED))
def test_settings_plumbed(name):
    """ReduceContext.from_settings carries each setting into the same
    field in both packages, with tests/test_wiring.py's value; the two
    contexts are twins."""
    kw, field, want = PLUMBED[name]
    got = ReduceContext.from_settings(
        ReductionSettings(geometry=TINY, **kw), "ML1")
    ref = JContext.from_settings(JSettings(geometry=JTINY, **kw), "ML1")
    assert field(got) == field(ref) == want
    assert ReduceContext.from_reference(ref) == got
