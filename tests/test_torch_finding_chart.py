"""The port's finding charts (report/finding_chart.py) against the JAX
package's, on the CPU: the 90-degree orientation and the value-preserving
shortcuts bit for bit, the arbitrary-angle Lanczos3 remap at float32
rounding (rtol 1e-5), coordinate parsing exactly, and the chart of a
Rice-compressed product (the cutout, orientation and annotations handed
to the renderer) the same, through ``chart_from_product`` and the
command line's ``--finding_chart``."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import assert_close, assert_exact  # noqa: E402

from blackbox_tpu.astro.wcs import TanWCS as JWCS  # noqa: E402
from blackbox_tpu.report import finding_chart as J  # noqa: E402
from blackbox_tpu_torch.astro.wcs import TanWCS  # noqa: E402
from blackbox_tpu_torch.report import finding_chart as T  # noqa: E402


def _wcs(*args, **kw):
    return TanWCS.simple(*args, **kw), JWCS.simple(*args, **kw)


@pytest.mark.parametrize("rot, flip", [(0.0, True), (0.0, False),
                                       (90.0, True), (180.0, False),
                                       (271.0, True)])
def test_orient_north_up(rot, flip):
    img = np.random.default_rng(0).normal(0, 1, (10, 12)).astype(np.float32)
    tw, jw = _wcs(150.0, -30.0, 1.0, img.shape, rot_deg=rot, flip_x=flip)
    assert_exact(np.ascontiguousarray(T.orient_north_up(img, tw)),
                 np.ascontiguousarray(J.orient_north_up(img, jw)))


def test_orient_data_value_preserving_routes():
    """Equal matrices return the data; the MeerLICHT/BlackGEM 90°+flip
    shortcut keeps every value."""
    img = np.random.default_rng(1).normal(0, 1, (64, 64)).astype(np.float32)
    tw, jw = _wcs(10.0, 5.0, 1.0, img.shape, rot_deg=17.0)
    assert_exact(T.orient_data(img, tw, wcs_out=tw, device="cpu"),
                 J.orient_data(img, jw, wcs_out=jw))
    for tel in ("ML1", "BG2"):
        got = T.orient_data(img, tw, mlbg_rot90_flip=True, tel=tel,
                            device="cpu")
        want = J.orient_data(img, jw, mlbg_rot90_flip=True, tel=tel)
        assert_exact(np.ascontiguousarray(got), np.ascontiguousarray(want))


@pytest.mark.parametrize("rot, out_rot", [(23.7, None), (17.0, 0.0),
                                          (-41.0, 5.0)])
def test_orient_data_lanczos_route(rot, out_rot):
    """The arbitrary-angle remap: a Lanczos3 gather on the device, the
    JAX package's to float32 rounding."""
    n = 101
    rng = np.random.default_rng(2)
    img = rng.normal(100.0, 3.0, (n, n)).astype(np.float32)
    img[30:33, 60:63] += 800.0
    tw, jw = _wcs(150.0, -30.0, 1.0, (n, n), rot_deg=rot)
    kw_t, kw_j = {}, {}
    if out_rot is not None:
        to, jo = _wcs(150.0, -30.0, 1.2, (n, n), rot_deg=out_rot)
        kw_t, kw_j = dict(wcs_out=to), dict(wcs_out=jo)
    got = T.orient_data(img, tw, device="cpu", **kw_t)
    want = J.orient_data(img, jw, **kw_j)
    assert got.dtype == np.float32 and got.shape == (n, n)
    assert_close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(img).max()))
    assert not np.array_equal(got, img)


@pytest.mark.parametrize("val, is_ra", [
    ("12:30:00", True), ("187.5", True), ("-10:45:32.3", False),
    (" -0:30:00", False), ("+5:07", False), ("23:59:59.99", True)])
def test_parse_coord(val, is_ra):
    assert T.parse_coord(val, is_ra) == J.parse_coord(val, is_ra)


def _product(tmp_path, mod_fits, mod_rice, wcs):
    img = np.random.default_rng(3).normal(100.0, 3.0, (256, 256)).astype(
        np.float32)
    img[126:131, 126:131] += 500.0
    h = mod_fits.Header()
    wcs.to_header(h)
    h["DATE-OBS"] = ("2024-01-01T02:03:04", "")
    h["FILTER"] = ("q", "")
    p = str(tmp_path / "ML1_20240101_020304_red.fits.fz")
    mod_rice.write_rice(p, img, h, qlevel=16)
    return p


def _captured(monkeypatch, mod, run):
    """What ``run`` hands the renderer: the cutout's orientation and the
    annotations, in place of the rendering."""
    seen = {}

    def fake(path, image, wcs, ra, dec, size_arcmin=3.0, title=None,
             wcs_out=None, cmap="gray_r", info=None, **kw):
        x, y = wcs.sky2pix(ra, dec)
        npix = int(size_arcmin * 60.0 / wcs.pixscale)
        half = npix // 2
        H, W = image.shape
        x0 = int(np.clip(round(float(x)) - half, 0, max(W - npix, 0)))
        y0 = int(np.clip(round(float(y)) - half, 0, max(H - npix, 0)))
        cut = np.asarray(image[y0:y0 + npix, x0:x0 + npix], np.float32)
        seen.update(path=path, title=title, info=info, cmap=cmap,
                    disp=(mod.orient_data(cut, wcs, **kw)
                          if kw else mod.orient_data(cut, wcs)))
        return path

    monkeypatch.setattr(mod, "finding_chart", fake)
    out = run()
    monkeypatch.undo()
    return out, seen


def test_chart_from_product_matches_jax(tmp_path, monkeypatch):
    from blackbox_tpu.io import fits as jfits, rice as jrice
    tw, jw = _wcs(150.0, -30.0, 1.0, (256, 256), rot_deg=8.0)
    p = _product(tmp_path, jfits, jrice, jw)
    ra, dec = (f"{float(v):.6f}" for v in jw.pix2sky(128.0, 128.0))
    monkeypatch.chdir(tmp_path)
    kw = dict(size_arcmin=2.0, target_name="SN test", output_format="png",
              info={"run": "r1", "PI": None})
    got, gs = _captured(monkeypatch, T, lambda: T.chart_from_product(
        p, ra, dec, device="cpu", **kw))
    want, ws = _captured(monkeypatch, J, lambda: J.chart_from_product(
        p, ra, dec, **kw))
    assert got == want == "ML1_20240101_020304_red_SN_test_fc.png"
    for k in ("path", "title", "info", "cmap"):
        assert gs[k] == ws[k], k
    assert_close(gs["disp"], ws["disp"], rtol=1e-5, atol=1e-3)


def test_finding_chart_cli(tmp_path, monkeypatch, capsys):
    """--finding_chart through both command lines: the same chart file,
    rendered."""
    pytest.importorskip("matplotlib")
    from blackbox_tpu.__main__ import main as jmain
    from blackbox_tpu.io import fits as jfits, rice as jrice
    from blackbox_tpu_torch.__main__ import main
    _, jw = _wcs(150.0, -30.0, 1.0, (256, 256), rot_deg=8.0)
    p = _product(tmp_path, jfits, jrice, jw)
    ra, dec = (f"{float(v):.6f}" for v in jw.pix2sky(128.0, 128.0))
    argv = ["--finding_chart", ra, dec, p, "--target_name", "SN test",
            "--output_format", "png", "--size_arcmin", "2"]
    outs = []
    for side, run in (("port", lambda: main(argv, device="cpu")),
                      ("jax", lambda: jmain(argv))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        assert run() == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        assert os.path.getsize(d / out) > 5000
        outs.append(out)
    assert outs[0] == outs[1]


def test_orient_data_defaults_to_the_card():
    """The remap runs on the card unless asked for another device: with
    no CUDA device the default refuses rather than running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.ones((16, 16), np.float32)
    tw, _ = _wcs(10.0, 5.0, 1.0, img.shape, rot_deg=30.0)
    with pytest.raises((RuntimeError, AssertionError)):
        T.orient_data(img, tw)
