"""The port's multi-device paths (``blackbox_tpu_torch/parallel/``, the
batched night) against the JAX package's on the CPU, case for case with
tests/test_parallel.py.  The JAX side runs on its 8-device CPU mesh
(tests/conftest.py); the port's meshes hold ``"cpu"`` eight times.

Tolerances.  The port's sharded paths are held to the port's dense
ones bit for bit (clean image, cosmic mask, every catalog column, the
PSF's too: the tail runs once over the gathered planes).  Against the
JAX package:
- ``median3x3_sharded``, ``lacosmic_sharded`` and ``lacosmic(coords)``:
  bit for bit, as JAX's own tests hold its sharded and dense paths (a
  block's outer 32 columns, its halo, are the caller's to drop, and
  only they may differ: the port's median filters keep a block's own
  border where the JAX package's pad it);
- ``extract_catalog_sharded``: ``nobjects``, ``npix``, ``peak`` and
  ``valid`` exact; the float columns of tests/test_parallel.py's exact
  list, ``bkg`` and ``bkg_std`` at rtol 1e-5 (two implementations'
  float32 sums: measured at most 4e-7 relative), ``flux_psf`` and
  ``fluxerr_psf`` at that test's rtol 1e-5, the stats at its rtol 1e-5,
  atol 1e-6, but for the PSF's chi2 and FWHM, held at
  tests/test_torch_reduce.py's rtol 1e-3 between the two packages;
- the batched reduce: masks and ``nobjects`` exact, the image at
  tests/test_torch_reduce.py's rtol 1e-5 with the pixel atol of the
  overscan level;
- ``run_day(device_batch=2)``: the TINY night of tests/night_parity.py
  at its tolerances (statuses, products, keywords and flags, masks bit
  for bit), with no fallback to the per-frame path.
"""

import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import night_parity as NP  # noqa: E402
import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import assert_close, assert_exact, n, t  # noqa: E402
from blackbox_tpu.core import maskbits  # noqa: E402
from blackbox_tpu.ops import cosmics as jcos  # noqa: E402
from blackbox_tpu.parallel import mesh as jmesh  # noqa: E402
from blackbox_tpu_torch.ops import cosmics as tcos  # noqa: E402
from blackbox_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from blackbox_tpu_torch.pipeline.reduce import ReduceContext  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _cpu_mesh(n_data, n_tile):
    return tmesh.make_mesh(n_data, n_tile, ["cpu"] * (n_data * n_tile))


def _jax_sharded(mesh, *arrays):
    sh = NamedSharding(mesh, P(None, "tile"))
    return [jax.device_put(jnp.asarray(a), sh) for a in arrays]


def test_make_mesh_shapes_and_devices():
    m = _cpu_mesh(2, 4)
    assert m.shape == {"data": 2, "tile": 4}
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    assert m.axis_devices("tile") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, 3, ["cpu"] * 8)
    if not torch.cuda.is_available():
        # the default is every visible card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(1, 1)


def test_halo_exchange_cols():
    x = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    blocks = tmesh.halo_exchange_cols(tmesh.split_cols(x, ["cpu"] * 3), 2)
    xp = torch.cat([x[:, :1], x[:, :1], x, x[:, -1:], x[:, -1:]], dim=1)
    for i, b in enumerate(blocks):
        assert torch.equal(b, xp[:, 4 * i:4 * i + 8])
    assert torch.equal(tmesh.join_cols([b[:, 2:-2] for b in blocks],
                                       "cpu"), x)


def test_median3x3_sharded_matches_jax(rng):
    img = rng.normal(0, 1, (64, 128)).astype(np.float32)
    img[10, 15] = np.nan                  # jnp.median's NaN, both sides
    mesh = jmesh.make_mesh(1, 8)
    want = jax.jit(lambda x: jmesh.median3x3_sharded(x, mesh))(
        *_jax_sharded(mesh, img))
    got = tmesh.median3x3_sharded(t(img), _cpu_mesh(1, 8))
    assert_exact(got, want)


def _cosmic_frame(rng):
    """tests/test_parallel.py's frame: cosmics on the 4-way seams, at
    the frame's border and in the bulk, and a masked row segment."""
    H, W = 96, 512
    img = rng.normal(300.0, 12.0, (H, W)).astype(np.float32)
    for (y, x) in [(40, 128), (41, 127), (50, 256), (20, 384),
                   (3, 2), (60, 300), (90, 509)]:
        img[y, x] += 4000.0
    inm = np.zeros((H, W), bool)
    inm[10, 100:140] = True
    return img, inm


LAC = dict(sigclip=8.0, strip_rows=32, windowed=False)


def test_lacosmic_sharded_matches_jax_and_dense(rng):
    img, inm = _cosmic_frame(rng)
    mesh = jmesh.make_mesh(2, 4)
    jp = jcos.LACosmicParams(**LAC)
    wc, wm = jax.jit(lambda d, m: jmesh.lacosmic_sharded(
        d, m, 10.0, mesh, jp))(*_jax_sharded(mesh, img, inm))
    tp = tcos.LACosmicParams(**LAC)
    gc, gm = tmesh.lacosmic_sharded(t(img), t(inm), 10.0, _cpu_mesh(2, 4),
                                    tp)
    assert_exact(gm, wm, "crmask")
    assert_exact(gc, wc, "clean")
    assert int(gm.sum()) >= 7
    dc, dm, _ = tcos.lacosmic(t(img), t(inm), 10.0, tp)
    assert_exact(gm, dm, "crmask against the dense port")
    assert_exact(gc, dc, "clean against the dense port")
    with pytest.raises(ValueError, match="influence radius"):
        tmesh.lacosmic_sharded(t(img), t(inm), 10.0, _cpu_mesh(1, 4), tp,
                               halo=29)


@pytest.mark.parametrize("cols,nan", [((0, 192), False), ((64, 384), False),
                                      ((320, 512), False),
                                      ((64, 384), True)],
                         ids=["left-edge", "interior", "right-edge",
                              "interior-nan"])
def test_lacosmic_coords_matches_jax(rng, cols, nan):
    """One column block of the frame through the JAX package's
    ``_lacosmic_dense_coords`` and the port's ``lacosmic(coords=...)``:
    equal but for the 32 halo columns on a side that is not the
    frame's edge (with NaN pixels beside two cosmics: the windowed
    clean keeps a NaN median)."""
    img, inm = _cosmic_frame(rng)
    W = img.shape[1]
    if nan:
        img[[39, 62], [202, 299]] = np.nan
        img[62, 296] += 3000.0
    c0, c1 = cols
    blk, mblk = img[:, c0:c1].copy(), inm[:, c0:c1].copy()
    jp = jcos.LACosmicParams(**LAC)
    wc, wm, wn = jax.jit(lambda d, m: jcos._lacosmic_dense_coords(
        d, m, 10.0, jp, (c0, W)))(jnp.asarray(blk), jnp.asarray(mblk))
    gc, gm, gn = tcos.lacosmic(t(blk), t(mblk), 10.0,
                               tcos.LACosmicParams(**LAC), coords=(c0, W))
    lo = 0 if c0 == 0 else 32
    hi = c1 - c0 if c1 == W else c1 - c0 - 32
    assert_exact(n(gm)[:, lo:hi], np.asarray(wm)[:, lo:hi], "crmask")
    assert_exact(n(gc)[:, lo:hi], np.asarray(wc)[:, lo:hi], "clean")
    assert int(n(gm)[:, lo:hi].sum()) >= 2
    assert_exact(gn, wn, "counts")


def test_masked_clean_keeps_nan_median(rng):
    """The coords path's clean is the JAX package's windowed masked
    median (``_win_masked_median``): an all-bad window takes the
    fallback, a NaN median stays NaN (the dense ``masked_median_filter``
    sends both to the fallback)."""
    from blackbox_tpu_torch.ops.filters import masked_median_filter
    a = rng.normal(100.0, 5.0, (24, 40)).astype(np.float32)
    a[6, 7] = a[15, 30] = np.nan
    bad = rng.random((24, 40)) < 0.2
    bad[10:15, 10:15] = True                       # one all-bad window
    fb = rng.normal(0.0, 1.0, (24, 40)).astype(np.float32)
    want = np.asarray(jcos._win_masked_median(
        jnp.asarray(a), jnp.asarray(bad, jnp.float32), jnp.asarray(fb),
        jnp.zeros((24, 40), bool)))
    got = n(masked_median_filter(t(a), t(bad), 5, 8, fallback=t(fb),
                                 nan_fallback=False))
    assert_exact(got[2:-2, 2:-2], want[2:-2, 2:-2])
    assert np.isnan(want[2:-2, 2:-2]).sum() >= 2
    assert got[12, 12] == fb[12, 12]
    dense = n(masked_median_filter(t(a), t(bad), 5, 8, fallback=t(fb)))
    assert not np.isnan(dense[2:-2, 2:-2]).any()


def _extract_inputs(rng):
    """tests/test_parallel.py's TINY-sized frame: Gaussian stars in the
    bulk, on the 4-way seams (80/160/240), straddling one, at the
    border; an EDGE band and a BAD row segment."""
    H, W = 132, 320
    img = rng.normal(200.0, 5.0, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for (yc, xc, f) in [(30, 40, 900.0), (50, 80, 1200.0),
                        (70, 160, 700.0), (90, 240, 1500.0),
                        (20, 158, 800.0), (64, 82, 650.0),
                        (5, 300, 1000.0), (128, 10, 1100.0)]:
        img += f * np.exp(-((yy - yc) ** 2 + (xx - xc) ** 2)
                          / (2 * 1.8 ** 2)).astype(np.float32)
    mask = np.zeros((H, W), np.uint8)
    mask[0:2, :] = maskbits.EDGE
    mask[100, 200:210] = maskbits.BAD
    return img, mask


def test_extract_catalog_sharded_matches_jax_and_dense(rng):
    from blackbox_tpu.config.defaults import ReductionSettings
    from blackbox_tpu.core.geometry import TINY
    from blackbox_tpu.ops.detection import DetectParams
    from blackbox_tpu.parallel.extract import (
        extract_catalog_sharded as jsharded)
    from blackbox_tpu.pipeline.reduce import ReduceContext as JCtx
    from blackbox_tpu_torch.parallel.extract import extract_catalog_sharded
    from blackbox_tpu_torch.pipeline.reduce import extract_catalog

    jctx = JCtx.from_settings(
        ReductionSettings(geometry=TINY), "ML1",
        det_params=DetectParams(nsigma=1.5, max_sources=256, label_iters=24,
                                moment_window=16, moment_window_big=32,
                                nbig_max=32),
        bkg_boxsize=16, apphot_radii=(2.0, 4.5, 9.0))
    ctx = ReduceContext.from_reference(jctx)
    img, mask = _extract_inputs(rng)
    mesh = jmesh.make_mesh(2, 4)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a, b: jsharded(jctx, a, b, mesh))(
            *_jax_sharded(mesh, img, mask)))
    got = extract_catalog_sharded(ctx, t(img), t(mask), _cpu_mesh(2, 4))
    dense = extract_catalog(ctx, t(img), t(mask))

    # the port's sharded path is its dense path, bit for bit
    for k in ("bkg", "bkg_std", "seg_nsources"):
        assert_exact(got[k], dense[k], k)
    for part in ("cat", "stats"):
        assert set(got[part]) == set(dense[part])
        for k in got[part]:
            assert_exact(got[part][k], dense[part][k], f"{part} {k}")

    # against the JAX package
    assert int(want["stats"]["nobjects"]) >= 8
    assert_exact(got["stats"]["nobjects"], want["stats"]["nobjects"])
    for k in ("bkg", "bkg_std"):
        assert_close(got[k], want[k], rtol=1e-5, what=k)
    gc, wc = got["cat"], want["cat"]
    valid = wc["valid"]
    assert_exact(gc["valid"], valid)
    for k in ("npix", "peak"):
        assert_exact(n(gc[k])[valid], wc[k][valid], k)
    for k in ("x", "y", "flux_iso", "flux_ap", "fluxerr_ap", "flux_psf",
              "fluxerr_psf"):
        assert_close(n(gc[k])[valid], wc[k][valid], rtol=1e-5, what=k)
    for k in want["stats"]:
        # chi2 and the PSF FWHM at tests/test_torch_reduce.py's 1e-3 (a
        # median of per-star chi2 and a moment ratio, both through the
        # float32 solve: 1.4e-5 apart here)
        rtol = 1e-3 if k in ("psf_chi2", "psf_fwhm_pix") else 1e-5
        assert_close(got["stats"][k], want["stats"][k], rtol=rtol,
                     atol=1e-6, what=k)

    with pytest.raises(ValueError, match="background boxes"):
        extract_catalog_sharded(ctx, t(img), t(mask), _cpu_mesh(1, 3))


def test_sharded_extraction_refuses_the_production_box():
    """Both packages refuse a background box that does not tile the
    column shards: the production 256 px at MeerLICHT's 10560 columns,
    over 1 or 4 shards (a fault of the reference the port matches,
    ROADMAP Queue 3)."""
    from blackbox_tpu.config.defaults import ReductionSettings
    from blackbox_tpu.core.geometry import MEERLICHT
    from blackbox_tpu.parallel.extract import (
        extract_pixel_stages_sharded as jstages)
    from blackbox_tpu.pipeline.reduce import ReduceContext as JCtx
    from blackbox_tpu_torch.parallel.extract import (
        extract_pixel_stages_sharded)
    jctx = JCtx.from_settings(ReductionSettings(geometry=MEERLICHT), "ML1")
    ctx = ReduceContext.from_reference(jctx)
    assert ctx.bkg_boxsize == 256
    sci = np.zeros((32, 10560), np.float32)
    mask = np.zeros((32, 10560), np.uint8)
    for n_tile in (1, 4):
        with pytest.raises(ValueError, match="background boxes"):
            jstages(jctx, jnp.asarray(sci), jnp.asarray(mask),
                    jmesh.make_mesh(1, n_tile))
        with pytest.raises(ValueError, match="background boxes"):
            extract_pixel_stages_sharded(ctx, t(sci), t(mask),
                                         _cpu_mesh(1, n_tile))


def _batched_ctx():
    """tests/test_parallel.py's context, both packages."""
    from test_parallel import _ctx
    jctx = _ctx()
    return jctx, ReduceContext.from_reference(jctx)


def _tiny_frames(seeds):
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.synth.generator import make_raw_science
    out = []
    for s in seeds:
        raw, _ = make_raw_science(TINY, np.random.default_rng(s), nstars=20,
                                  ncosmics=4, trail=False, nsat=0)
        out.append(tuple(np.ascontiguousarray(a, np.float32)
                         for a in TINY.split_raw(raw)))
    return out


def test_batched_reduce_matches_jax_and_single():
    """8-way data-parallel reduce: each frame bit for bit the port's
    single-frame program, and against the JAX package's batched reduce
    on its 8-device mesh."""
    from blackbox_tpu_torch.pipeline.reduce import make_reduce_fn
    jctx, ctx = _batched_ctx()
    frames = _tiny_frames(range(100, 108))
    batch = tuple(np.stack([f[k] for f in frames]) for k in range(3))
    jm = jmesh.make_mesh(8, 1)
    want = jax.tree_util.tree_map(np.asarray, jmesh.make_batched_reduce(
        jctx, jm)(*jmesh.shard_batch(tuple(map(jnp.asarray, batch)), jm)))
    got = tmesh.make_batched_reduce(ctx, _cpu_mesh(8, 1))(
        *(t(a) for a in batch))
    assert len(got) == 8
    single = make_reduce_fn(ctx, device="cpu")
    for i, (g, f) in enumerate(zip(got, frames)):
        ref = single(*(t(a) for a in f), None, None, None, None)
        assert_exact(g["image"], ref["image"], f"frame {i} image")
        assert_exact(g["mask"], ref["mask"], f"frame {i} mask")
        for k, v in g["cat"].items():
            assert_exact(v, ref["cat"][k], f"frame {i} cat {k}")
        for k, v in g["stats"].items():
            assert_exact(v, ref["stats"][k], f"frame {i} stats {k}")
        assert_exact(g["mask"], want["mask"][i], f"frame {i} jax mask")
        assert_exact(g["stats"]["nobjects"], want["stats"]["nobjects"][i])
        level = float(np.abs(want["stats"]["biasm"][i]).max())
        assert_close(g["image"], want["image"][i], rtol=1e-5,
                     atol=NP.pixel_atol(level), what=f"frame {i} image")


def test_shard_batch_splits_over_data():
    x = torch.arange(6 * 2).reshape(6, 2)
    shards = tmesh.shard_batch((x, {"y": x + 1}), _cpu_mesh(3, 1))
    assert [s[0].tolist() for s in shards] == [x[2 * i:2 * i + 2].tolist()
                                               for i in range(3)]
    assert torch.equal(shards[2][1]["y"], x[4:] + 1)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch((x,), _cpu_mesh(4, 1))


def test_first_host_and_single_process():
    from blackbox_tpu.parallel.distributed import _first_host as jfirst
    from blackbox_tpu_torch.parallel.distributed import (
        _first_host, init_multihost, process_rank)
    for nl in ("n[01-03],m05", "node7", "gpu[12,14]", "a,b"):
        assert _first_host(nl) == jfirst(nl)
    assert init_multihost(num_processes=1) is False
    assert process_rank() == (0, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_batched_reduce_two_process_group():
    """A real two-process torch.distributed group (gloo, on the CPU):
    both ranks agree on an all_reduce, and the batched reduce of a
    2-frame batch gives each rank its own frame, bit for bit the
    single-process program's (tests/test_parallel.py's two-process
    cases)."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from blackbox_tpu_torch.config.defaults import ReductionSettings
        from blackbox_tpu_torch.core.geometry import TINY
        from blackbox_tpu_torch.ops.cosmics import LACosmicParams
        from blackbox_tpu_torch.ops.detection import DetectParams
        from blackbox_tpu_torch.ops.satdet import SatDetParams
        from blackbox_tpu_torch.parallel.distributed import (
            init_multihost, process_rank)
        from blackbox_tpu_torch.parallel.mesh import (make_batched_reduce,
                                                      make_mesh)
        from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,
                                                        make_reduce_fn)
        from blackbox_tpu_torch.synth.generator import make_raw_science
        pid, port = int(sys.argv[1]), sys.argv[2]
        assert init_multihost(coordinator="127.0.0.1:" + port,
                              num_processes=2, process_id=pid)
        assert process_rank() == (pid, 2)
        v = torch.tensor([pid + 1.0])
        dist.all_reduce(v)
        assert float(v) == 3.0, float(v)
        ctx = ReduceContext.from_settings(
            ReductionSettings(geometry=TINY), "ML1",
            lac_params=LACosmicParams(sigclip=10.0, strip_rows=66),
            det_params=DetectParams(nsigma=1.5, max_sources=256,
                                    label_iters=24),
            sat_params=SatDetParams(bin_factor=2, nsigma=8.0,
                                    trail_halfwidth=4),
            bkg_boxsize=33, apphot_radii=(2.0, 4.5, 9.0))
        frames = []
        for i in range(2):
            raw, _ = make_raw_science(TINY, np.random.default_rng(300 + i),
                                      nstars=20, ncosmics=4, trail=False,
                                      nsat=0)
            frames.append([torch.as_tensor(np.asarray(a, np.float32))
                           for a in TINY.split_raw(raw)])
        batch = [torch.stack([f[k] for f in frames]) for k in range(3)]
        out = make_batched_reduce(ctx, make_mesh(1, 1, ["cpu"]))(*batch)
        mine = [k for k, o in enumerate(out) if o is not None]
        assert mine == [pid], mine
        ref = make_reduce_fn(ctx, device="cpu")(*frames[pid], None, None,
                                                 None, None)
        for key in ("image", "mask"):
            assert torch.equal(out[pid][key], ref[key]), key
        assert int(out[pid]["stats"]["nobjects"]) == \\
            int(ref["stats"]["nobjects"])
        dist.barrier()
        dist.destroy_process_group()
        print("BATCHED_2PROC_OK", pid, "frame", mine[0], flush=True)
    """)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=REPO, env=env,
                              text=True) for i in range(2)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out)
    for i, out in enumerate(outs):
        assert f"BATCHED_2PROC_OK {i} frame {i}" in out, out[-3000:]


def test_run_day_device_batch_matches_jax(tmp_path):
    """The TINY night through both packages' ``run_day`` with
    ``device_batch=2``: the calibration frames one at a time, the two
    visits as one device batch, published per frame through
    ``process_file(device_override=...)``; held by night_parity."""
    from test_driver import _ctx as jax_night_ctx
    from blackbox_tpu.config.defaults import ReductionSettings as JSettings
    from blackbox_tpu.core.geometry import TINY as JTINY
    from blackbox_tpu.orchestration.paths import DataTree as JTree
    from blackbox_tpu.orchestration.scheduler import run_day as jrun_day
    from blackbox_tpu.pipeline.driver import Pipeline as JPipeline
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.orchestration.scheduler import run_day
    from blackbox_tpu_torch.pipeline.driver import Pipeline

    raw_root = str(tmp_path / "raw")
    _, stars = NP.tiny_night(raw_root)
    query = NP.ref_catalog(stars, TINY.red_shape)
    js = JSettings(geometry=JTINY, pixscale=NP.PIXSCALE, create_ref=True)
    js.device_batch = 2
    s = ReductionSettings(geometry=TINY, pixscale=NP.PIXSCALE,
                          create_ref=True)
    s.device_batch = 2
    runs = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        shutil.copytree(raw_root, root)
        if side == "jax":
            pipe = JPipeline(JTree(root, "ML1"), "ML1", js,
                             jax_night_ctx(js), ref_catalog=query)
            rep = jrun_day(pipe, NP.DATE)
        else:
            pipe = Pipeline(DataTree(root, "ML1"), "ML1", s, NP.tiny_ctx(s),
                            ref_catalog=query, device="cpu")
            rep = run_day(pipe, NP.DATE)
            assert rep.batch_fallbacks == 0
        assert rep.nprocessed == 8 and rep.nreduced == 8
        runs[side] = ([r for _, r in rep.results], root)
    a, b = runs["port"], runs["jax"]
    NP.check_statuses(a, b)
    NP.check_headers(a, b, NP.overscan_level(b))
    assert NP.check_masks(a, b) == 3
    NP.check_images(a, b, NP.overscan_level(b))
    NP.check_catalogs(a, b)
    x, y = NP.check_transients(a, b)
    tx, ty, _ = NP.TRANS
    assert np.hypot(x - tx, y - ty).min() < 2.0
    assert a[0][-1].header["TRANS-P"] is True
