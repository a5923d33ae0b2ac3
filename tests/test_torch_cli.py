"""The port's command line (``python -m blackbox_tpu_torch``, its
``main(argv, device)``) against the JAX package's ``main(argv)`` on
TINY trees, the port on the CPU (``device="cpu"``).

``--buildref`` runs over three visits of field 42 reduced once by the
port (``night_parity.tiny_visits``, no field reference yet), in one
copy of the tree for each package.  The first call publishes a
co-add, the second finds it ``not_deeper``.  The published products
are held as ``test_torch_buildref.py`` holds them.

A fault of the reference that the port matches: the command line
builds the reference without an extraction context, so no
``_psf.fits`` and no ``_red_cat.fits`` is published beside the
co-add, and the driver, which reads both before it subtracts, cannot
subtract against it (``test_buildref_reference_fault``).
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import night_parity as NP  # noqa: E402
import torch_parity  # noqa: E402,F401  (pins torch threads)
from blackbox_tpu.__main__ import main as jmain  # noqa: E402
from blackbox_tpu_torch.__main__ import main  # noqa: E402

STEM = os.path.join("ML1", "ref", "00042", "ML1_00042_q_coadd")


def _run(fn, argv, **kw):
    """(return code, standard output) of one command-line call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv, **kw)
    return rc, out.getvalue()


def _port(argv):
    return _run(main, argv, device="cpu")


def _jax(argv):
    return _run(jmain, argv)


@pytest.fixture(scope="module")
def buildref(tmp_path_factory):
    """{side: (root, [(rc, out), (rc, out)])}: two --buildref calls of
    each package in its copy of the reduced tree."""
    base = str(tmp_path_factory.mktemp("cli"))
    red = os.path.join(base, "red")
    res = NP.tiny_visits(red, create_ref=False)
    assert [r.status for r in res] == ["reduced"] * 9
    out = {}
    for side, fn in (("port", _port), ("jax", _jax)):
        root = os.path.join(base, side)
        shutil.copytree(red, root)
        argv = ["--buildref", "42", "--data_root", root, "--geometry",
                "tiny"]
        out[side] = (root, [fn(argv), fn(argv)])
    return out


def test_buildref_published_then_not_deeper(buildref):
    for side in ("port", "jax"):
        root, calls = buildref[side]
        (rc1, out1), (rc2, out2) = calls
        assert rc1 == rc2 == 0, (side, out1, out2)
        assert out1.startswith("field 42 q: published "), out1
        assert out2.startswith("field 42 q: not_deeper "), out2
        assert os.path.exists(os.path.join(root, STEM + "_red.fits.fz"))


def test_buildref_products_match_jax(buildref):
    from blackbox_tpu_torch.io.rice import read_rice
    pa, pb = (buildref[s][0] for s in ("port", "jax"))
    x, ha = read_rice(os.path.join(pa, STEM + "_mask.fits.fz"))
    y, hb = read_rice(os.path.join(pb, STEM + "_mask.fits.fz"))
    np.testing.assert_array_equal(x, y)
    for k in ("NIMAGES", "R-IM1", "R-IM2", "R-IM3", "R-ASWARP",
              "R-NSIGMA", "PC-ZP"):
        assert ha[k] == hb[k], k
    assert abs(ha["LIMMAG"] - hb["LIMMAG"]) <= 1e-3
    for suffix in ("_red.fits.fz", "_bkgstd.fits.fz"):
        x, _ = NP.decode(os.path.join(pa, STEM + suffix))
        y, step = NP.decode(os.path.join(pb, STEM + suffix))
        assert np.all(np.abs(x - y) <= step + 1e-3 + 1e-5 * np.abs(y))


def test_buildref_reference_fault(buildref):
    """The reference fault of the module note, in both packages: no PSF
    and no catalog beside the co-add, and the driver's subtraction step
    fails reading them (a science frame of the field then gets
    TRANS-P = False)."""
    from blackbox_tpu.config.defaults import ReductionSettings as JS
    from blackbox_tpu.core.geometry import TINY as JTINY
    from blackbox_tpu.orchestration.paths import DataTree as JTree
    from blackbox_tpu.pipeline.driver import Pipeline as JPipeline
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.io.fits import Header
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline
    for side in ("port", "jax"):
        root = buildref[side][0]
        ref = os.listdir(os.path.dirname(os.path.join(root, STEM)))
        assert not any(f.endswith(("_psf.fits", "_red_cat.fits"))
                       for f in ref), (side, ref)
        if side == "port":
            pipe = Pipeline(DataTree(root, "ML1"), "ML1",
                            ReductionSettings(geometry=TINY), device="cpu")
        else:
            pipe = JPipeline(JTree(root, "ML1"), "ML1",
                             JS(geometry=JTINY))
        h = Header()
        h["OBJECT"] = "42"
        h["FILTER"] = "q"
        assert pipe._find_ref(42, "q").endswith("_coadd_red.fits.fz")
        with pytest.raises(FileNotFoundError, match="_coadd_psf.fits"):
            pipe._transients(h, None, None, None, None, None, None, None,
                             None)


@pytest.fixture(scope="module")
def bias(tmp_path_factory):
    """tests/test_cli_cluster.py's bias frame, in one tree a package."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.synth.observation import write_observation
    base = str(tmp_path_factory.mktemp("image"))
    rel = os.path.join("ML1", "raw", "2026", "03", "05",
                       "ML1_20260305_230000.fits")
    write_observation(os.path.join(base, "raw", rel), TINY,
                      np.random.default_rng(2), "bias",
                      mjd_start=iso2mjd("2026-03-05T23:00:00.000"))
    roots = {}
    for side in ("port", "jax", "card"):
        roots[side] = os.path.join(base, side)
        shutil.copytree(os.path.join(base, "raw"), roots[side])
    return roots, rel


RED = os.path.join("ML1", "red", "2026", "03", "05", "bias",
                   "ML1_20260305_230000_red.fits.fz")


def test_image_matches_jax(bias):
    """--image reduces the bias in both packages; the products agree as
    the driver's do (tests/test_torch_driver.py: one Rice step plus the
    pixel atol)."""
    roots, rel = bias
    for side, fn in (("port", _port), ("jax", _jax)):
        root = roots[side]
        rc, out = fn(["--data_root", root, "--image",
                      os.path.join(root, rel), "--geometry", "tiny"])
        assert rc == 0, (side, out)
        assert "reduced" in out, out
    x, _ = NP.decode(os.path.join(roots["port"], RED))
    y, step = NP.decode(os.path.join(roots["jax"], RED))
    from blackbox_tpu_torch.io.rice import read_rice
    level = float(read_rice(os.path.join(roots["jax"], RED))[1]["BIASM1"])
    assert np.all(np.abs(x - y) <= step + NP.pixel_atol(level))


def test_image_defaults_to_the_card(bias):
    """Without a device the pixel work goes to the card: with no CUDA
    device the frame fails, contained, and the command returns 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    roots, rel = bias
    root = roots["card"]
    rc, out = _run(main, ["--data_root", root, "--image",
                          os.path.join(root, rel), "--geometry", "tiny"])
    assert rc == 1 and "error" in out and "CUDA" in out.upper(), out
    assert not os.path.exists(os.path.join(root, RED))


def test_requires_a_target():
    assert _port(["--telescope", "ML1"])[0] == _jax(["--telescope",
                                                      "ML1"])[0] == 2


def test_finding_chart_not_ported():
    with pytest.raises(NotImplementedError, match="finding_chart"):
        main(["--finding_chart", "150.0", "-30.0", "x_red.fits"],
             device="cpu")


def test_device_batch_not_ported(tmp_path):
    """day mode with settings.device_batch > 1 (the JAX package's
    sharded multi-device batches) is refused, naming parallel/."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.orchestration.scheduler import run_day
    from blackbox_tpu_torch.pipeline.driver import Pipeline
    from blackbox_tpu_torch.synth.observation import write_observation
    tree = DataTree(str(tmp_path), "ML1")
    write_observation(os.path.join(tree.raw_dir("20260305"),
                                   "ML1_20260305_230000.fits"), TINY,
                      np.random.default_rng(3), "object",
                      mjd_start=iso2mjd("2026-03-05T23:00:00.000"),
                      nstars=5)
    s = ReductionSettings(geometry=TINY)
    s.device_batch = 2
    with pytest.raises(NotImplementedError, match="parallel/"):
        run_day(Pipeline(tree, "ML1", s, device="cpu"), "20260305")


def test_read_path_filters_and_genlog(tmp_path):
    """tests/test_cli_cluster.py's --read_path / --recursive /
    --imgtypes / --name_genlog run on the port."""
    from blackbox_tpu_torch.astro.time import iso2mjd
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.synth.observation import write_observation
    root = str(tmp_path)
    stage = os.path.join(root, "staging", "deep", "nested")
    write_observation(os.path.join(stage, "ML1_20260305_231000.fits"), TINY,
                      np.random.default_rng(3), "bias",
                      mjd_start=iso2mjd("2026-03-05T23:10:00.000"))
    genlog = os.path.join(root, "general.log")
    common = ["--data_root", root, "--geometry", "tiny", "--mode", "day",
              "--date", "20260305", "--read_path",
              os.path.join(root, "staging")]
    rc, out = _port(common + ["--recursive", "true", "--imgtypes", "flat",
                              "--name_genlog", genlog])
    assert rc == 0 and "processed=0" in out
    assert "genlogfile created" in open(genlog).read()
    rc, out = _port(common)
    assert rc == 0 and "processed=0" in out


def test_obslog_and_master_date_match_jax(buildref):
    """--obslog writes the same night log in both packages; --master_date
    finds the night's masters in both."""
    texts = {}
    for side, fn in (("port", _port), ("jax", _jax)):
        root = buildref[side][0]
        rc, out = fn(["--obslog", NP.DATE, "--data_root", root,
                      "--geometry", "tiny"])
        assert rc == 0
        path = out.strip().splitlines()[-1]
        assert path.startswith(root) and path.endswith("_obslog.txt")
        texts[side] = open(path).read().replace(root, "<root>")
        rc, out = fn(["--master_date", NP.DATE, "--data_root", root,
                      "--geometry", "tiny"])
        assert rc == 0 and "masters built: 2/2" in out, (side, out)
    assert texts["port"] == texts["jax"]
    assert "ML1_20260301" in texts["port"]
