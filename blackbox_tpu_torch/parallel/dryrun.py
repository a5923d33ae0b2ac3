"""The multi-device dry run: the pipeline's sharded paths on a mesh of
``n_devices`` entries, each held to its single-device result (the
port's counterpart of the JAX package's ``dryrun_multichip``).

    python -c "from blackbox_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

Two parallel axes, as in the JAX package: ``data`` (frames of a night
batch) and ``tile`` (columns of one mosaic).  The devices default to
every visible card; ``devices=`` may repeat one (four entries of
``cuda:0`` run every section on one card) or name the CPU.  Each
section prints one OK line, and the record is printed again at the
end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _example(geom, seed=0):
    """A synthetic raw frame's (chan, osv, osh) stacks, float32 on the
    host."""
    from blackbox_tpu_torch.synth.generator import make_raw_science
    rng = np.random.default_rng(seed)
    raw, _ = make_raw_science(geom, rng, nstars=30, ncosmics=8, trail=True,
                              nsat=1)
    return tuple(torch.as_tensor(np.asarray(a, np.float32))
                 for a in geom.split_raw(raw))


def _ctx(geom, max_sources=512):
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams
    from blackbox_tpu_torch.ops.detection import DetectParams
    from blackbox_tpu_torch.ops.satdet import SatDetParams
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    return ReduceContext.from_settings(
        ReductionSettings(geometry=geom), "ML1",
        lac_params=LACosmicParams(strip_rows=min(264, geom.ysize_chan)),
        det_params=DetectParams(max_sources=max_sources, label_iters=24),
        sat_params=SatDetParams(bin_factor=2),
        bkg_boxsize=min(256, geom.red_shape[0] // 4))


def _same(a, b, what):
    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what}: sharded and single-device results "
                             "differ")


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """Run the batched reduce, sharded L.A.Cosmic, sharded extraction,
    data-parallel ZOGY and the production-shaped science pair on a mesh
    of ``n_devices`` entries of ``devices``; returns the sections' OK
    lines."""
    from blackbox_tpu_torch.core.geometry import TINY, CCDGeometry
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams, lacosmic
    from blackbox_tpu_torch.ops.stats import median
    from blackbox_tpu_torch.ops.transients import TransientParams
    from blackbox_tpu_torch.ops.warp import grid_shift_ranges
    from blackbox_tpu_torch.ops.zogy import ZogyParams, zogy_subtract
    from blackbox_tpu_torch.parallel.extract import extract_catalog_sharded
    from blackbox_tpu_torch.parallel.mesh import (
        lacosmic_sharded, make_batched_reduce, make_mesh, map_batch)
    from blackbox_tpu_torch.pipeline.reduce import (extract_catalog,
                                                    make_reduce_fn)
    from blackbox_tpu_torch.pipeline.subtract import (_science_back,
                                                      _science_front)

    n_tile = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_tile
    mesh = make_mesh(n_data, n_tile, devices)
    dev0 = mesh.devices[0][0]
    sections = []

    def ok(line):
        sections.append(line)
        print(line, flush=True)

    geom = TINY
    ctx = _ctx(geom, max_sources=128)

    # ---- data-parallel batched reduce over the 'data' axis ----
    B = n_data
    frames = [_example(geom, seed=i) for i in range(B)]
    batch = tuple(torch.stack([f[k] for f in frames]) for k in range(3))
    out = make_batched_reduce(ctx, mesh)(*batch)
    single = make_reduce_fn(ctx, device=dev0)(*frames[0], None, None,
                                              None, None)
    _same(out[0]["image"], single["image"], "batched reduce image")
    _same(out[0]["mask"], single["mask"], "batched reduce mask")
    nobj = [int(o["stats"]["nobjects"]) for o in out]
    if sum(nobj) <= 0:
        raise AssertionError("batched reduce found no source")
    ok(f"section batched-reduce OK: batch {B} over data={n_data}, "
       f"nobjects={nobj}")
    sci = [o["image"] for o in out]
    mask = [o["mask"] for o in out]

    # ---- tile parallelism: the dense L.A.Cosmic over column shards ----
    if n_tile > 1:
        # the reduced frame again, with cosmic hits, two on a seam
        img, msk = sci[0].to(dev0).clone(), mask[0].to(dev0) != 0
        H, W = img.shape
        seam = W // n_tile
        img[[30, 31, 60, 90, H // 2], [seam, seam - 1, W // 3, 40,
                                       W - 20]] += 4000.0
        p = LACosmicParams(strip_rows=min(64, geom.red_shape[0]),
                           windowed=False)
        clean, crm = lacosmic_sharded(img, msk, 10.0, mesh, p)
        dclean, dcrm, _ = lacosmic(img, msk, 10.0, p)
        _same(crm, dcrm, "sharded L.A.Cosmic mask")
        _same(clean, dclean, "sharded L.A.Cosmic image")
        if int(crm.sum()) < 5:
            raise AssertionError("sharded L.A.Cosmic missed the hits")
        ok(f"section sharded-lacosmic OK: tile={n_tile}, "
           f"{int(crm.sum())} cosmic pixels (parity with dense)")

    # ---- tile-sharded extraction on a tile-only mesh ----
    if n_tile > 1:
        tmesh = make_mesh(1, n_devices, devices)
        Wm = geom.red_shape[1]
        box = next((b for b in (32, 20, 16, 10, 8)
                    if Wm % n_devices == 0
                    and (Wm // n_devices) % b == 0), None)
        if box is None:
            raise AssertionError(
                f"no background box in (32, 20, 16, 10, 8) tiles width "
                f"{Wm} over {n_devices} column shards")
        ctx_t = dataclasses.replace(ctx, bkg_boxsize=box)
        img0, msk0 = sci[0].to(dev0), mask[0].to(dev0)
        dense = extract_catalog(ctx_t, img0, msk0)
        shd = extract_catalog_sharded(ctx_t, img0, msk0, tmesh)
        n_d, n_s = int(dense["stats"]["nobjects"]), \
            int(shd["stats"]["nobjects"])
        if n_s != n_d:
            raise AssertionError(f"sharded extraction: {n_s} sources, "
                                 f"dense {n_d}")
        _same(shd["bkg"], dense["bkg"], "sharded extraction background")
        _same(shd["cat"]["x"], dense["cat"]["x"], "sharded extraction x")
        ok(f"section sharded-extraction OK: box={box}, nobjects={n_s} "
           "(parity with dense)")

    # ---- data-parallel ZOGY over the 'data' axis (the split FFT, K6 on
    # the card) ----
    yy = torch.arange(25, dtype=torch.float32) - 12.0
    psf = torch.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / 8.0)
    psf = psf / torch.sum(psf)
    zp = ZogyParams(pad_fast=True, pack_fft=True,
                    kernel_stamp=min(256, geom.red_shape[0]), fft="split")

    def sub_one(new, ref, vn, vr, psf_):
        o = zogy_subtract(new, ref, psf_, psf_, 1.0, 1.0, var_bkg_new=vn,
                          var_bkg_ref=vr, params=zp, want_psf_d=False)
        return torch.max(torch.abs(o["Scorr"]))

    news = torch.stack([s.cpu() for s in sci])
    refs = torch.roll(news, 1, dims=0)
    vmaps = torch.clamp(torch.abs(news) + 1.0, min=1.0)
    vmaps_r = torch.roll(vmaps, 1, dims=0)
    peaks = map_batch(sub_one, mesh, (news, refs, vmaps, vmaps_r), (psf,))
    peak0 = sub_one(*(t[0].to(dev0) for t in (news, refs, vmaps, vmaps_r)),
                    psf.to(dev0))
    if abs(float(peaks[0]) - float(peak0)) > 1e-3 * max(1.0,
                                                         abs(float(peak0))):
        raise AssertionError(f"data-parallel ZOGY: {float(peaks[0])} "
                             f"against {float(peak0)}")
    ok(f"section data-parallel-zogy OK: batch {B}, peaks="
       f"{[round(float(x), 1) for x in peaks]}")

    # ---- production-shaped geometry: the science pair, one frame a
    # mesh entry over the flattened mesh ----
    gprod = CCDGeometry(ysize_chan=660, xsize_chan=165, ysize_os=20,
                        xsize_os=32, ncut_vert=5, ncut_hori=10)
    Hp, Wp = gprod.red_shape
    ctx_p = dataclasses.replace(_ctx(gprod, max_sources=256),
                                bkg_boxsize=120)     # divides 1320
    zp_p = ZogyParams(pad_fast=True, pack_fft=True, kernel_stamp=256)
    tp_p = TransientParams(max_transients=256)

    with torch.inference_mode():
        f = _science_front(ctx_p, *(t.to(dev0) for t in
                                    _example(gprod, seed=100)),
                           None, None, None, None)
    fr = 1.2
    cat = f["cat"]
    ref = (f["sub"] * fr, f["bkg_std"] * fr, f["mask"], f["psf_centre"],
           median(f["bkg_std"]) * fr,
           {"x": cat["x"], "y": cat["y"], "flux": cat["flux_psf"] * fr,
            "fluxerr": cat["fluxerr_psf"] * fr, "valid": cat["valid"]})
    del f

    # registration: a small rotation and offset, as in production
    th = np.deg2rad(0.05)
    ct, st = np.cos(th), np.sin(th)
    cy, cx = 0.5 * Hp, 0.5 * Wp
    step_px = 32
    gy = np.arange(0, Hp + step_px, step_px, np.float64)
    gx = np.arange(0, Wp + step_px, step_px, np.float64)
    gyy, gxx = np.meshgrid(gy - cy, gx - cx, indexing="ij")
    sx = (cx + ct * gxx + st * gyy + 1.7).astype(np.float32)
    sy = (cy - st * gxx + ct * gyy - 1.2).astype(np.float32)
    ranges = grid_shift_ranges(sy, sx, step=step_px, blocks=8)

    def pair_one(chan, osv, osh, sy_, sx_, rsub, rstd, rmask, rpsf, sr,
                 rx, ry, rflux, rfluxerr, rvalid):
        fr_ = _science_front(ctx_p, chan, osv, osh, None, None, None, None)
        b = _science_back(fr_["sub"], fr_["bkg_std"], fr_["mask"],
                          fr_["psf_centre"], fr_["cat"],
                          fr_["stats"]["bkg_std"], rsub, rstd, rmask,
                          (sy_, sx_), rpsf, sr,
                          {"x": rx, "y": ry, "flux": rflux,
                           "fluxerr": rfluxerr, "valid": rvalid},
                          zp_p, tp_p, remap_ranges=ranges,
                          remap_step=step_px)
        return {"ntrans": int(b["trans_stats"]["t_ntrans"]),
                "fratio": float(b["trans_stats"]["z_fratio"]),
                "scorr_max": float(torch.max(torch.abs(b["Scorr"])))}

    # every mesh entry runs one science frame: frames ride the whole
    # mesh flattened (the throughput layout of a night batch)
    flat = [d for row in mesh.devices for d in row]
    dmesh = make_mesh(n_devices, 1, flat)
    argsp = [_example(gprod, seed=200 + i) for i in range(n_devices)]
    batchp = tuple(torch.stack([a[k] for a in argsp]) for k in range(3))
    rc = ref[5]
    replicated = (torch.as_tensor(sy), torch.as_tensor(sx), *ref[:5],
                  rc["x"], rc["y"], rc["flux"], rc["fluxerr"], rc["valid"])
    outp = map_batch(pair_one, dmesh, batchp, replicated)
    with torch.inference_mode():
        dense0 = pair_one(*(t.to(dev0) for t in argsp[0]),
                          *(t.to(dev0) for t in replicated))
    if outp[0]["ntrans"] != dense0["ntrans"]:
        raise AssertionError(f"science pair: {outp[0]['ntrans']} "
                             f"transients, dense {dense0['ntrans']}")
    s_sh, s_d = outp[0]["scorr_max"], dense0["scorr_max"]
    if abs(s_sh - s_d) > 1e-3 * max(1.0, abs(s_d)):
        raise AssertionError(f"science pair: max |Scorr| {s_sh} against "
                             f"{s_d}")
    ok(f"section science-pair OK: geometry {gprod.red_shape} (2x8 "
       f"channels, os {gprod.ysize_os}/{gprod.xsize_os}, cuts "
       f"{gprod.ncut_hori}/{gprod.ncut_vert}), batch {n_devices} over "
       f"'data', ntrans={[o['ntrans'] for o in outp]}, "
       f"fratio0={outp[0]['fratio']:.3f}")

    print("==== dryrun_multichip record ====", flush=True)
    for line in sections:
        print(line, flush=True)
    print(f"dryrun_multichip OK: mesh data={n_data} tile={n_tile} on "
          f"{sorted({str(d) for row in mesh.devices for d in row})}, "
          f"batch {B}, nobjects={nobj}, science-pair batch {n_devices} @ "
          f"{gprod.red_shape}", flush=True)
    return sections
