"""Run orchestration: day-mode batch runs and night-mode streaming.

Rebuild of the reference's ``run_blackbox`` (reference blackbox.py:
128-483): day mode sorts the date's raw frames by IMAGETYP and reduces
bias -> dark -> flat -> object (sort_files 7573-7648); night mode tails
the raw directory with the ingest watcher until one hour past sunrise
and drains the queue (392-466), then builds the obslog.  Where the
reference forks one process per image, frames here flow through one
process that owns the GPU (port of
:mod:`blackbox_tpu.orchestration.scheduler`), and multi-device
throughput comes from sharded batches (blackbox_tpu_torch.parallel),
not fork().
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import time
from typing import Callable, Optional

from blackbox_tpu_torch.astro.ephem import sun_altitude
from blackbox_tpu_torch.astro.time import datetime2mjd
from blackbox_tpu_torch.io.fits import read_fits
from blackbox_tpu_torch.io.storage import list_files
from blackbox_tpu_torch.orchestration.ingest import DirectoryWatcher, drain_until

log = logging.getLogger(__name__)

IMGTYPE_ORDER = {"bias": 0, "dark": 1, "flat": 2, "object": 3}


def sort_files(paths, read_header=None):
    """Order raw frames for reduction: bias, dark, flat, then science
    (reference sort_files, blackbox.py:7573-7648).  Unreadable files
    sort last and are kept (the per-frame driver rejects them cleanly)."""
    def key(p):
        try:
            h = read_header(p) if read_header else read_fits(p)[0][1]
            t = str(h.get("IMAGETYP", "object")).strip().lower()
            return (IMGTYPE_ORDER.get(t, 4), p)
        except Exception:
            return (9, p)
    return sorted(paths, key=key)


@dataclasses.dataclass
class RunReport:
    nprocessed: int = 0
    nreduced: int = 0
    nskipped: int = 0
    nrejected: int = 0
    nerror: int = 0
    # frames of a failed device batch that were reduced one at a time
    batch_fallbacks: int = 0
    results: list = dataclasses.field(default_factory=list)

    def add(self, path, result):
        self.nprocessed += 1
        self.results.append((path, result))
        key = f"n{result.status}"
        setattr(self, key, getattr(self, key, 0) + 1)


def run_day(pipeline, date: str, image_filter: Optional[Callable] = None,
            force: bool = False, read_path: Optional[str] = None,
            recursive: bool = False) -> RunReport:
    """Batch-reduce one night's raw directory (reference day mode).

    read_path/recursive: read raw frames from this directory instead of
    the tree's raw/yyyy/mm/dd, optionally recursing into subfolders
    (reference --read_path/--recursive, blackbox.py:285-330, 8150-8157).

    With ``settings.device_batch > 1`` the science frames' device work
    (calibration + extraction) runs as sharded multi-frame batches over
    the available devices — N chips reduce N frames per step — and each
    frame's host publication then consumes the precomputed outputs.
    """
    raw_dir = read_path or pipeline.tree.raw_dir(date)
    glob_mid = "/**/" if recursive else "/"
    paths = list_files(raw_dir + glob_mid + "*.fits*")
    if image_filter:
        paths = [p for p in paths if image_filter(p)]
    report = RunReport()
    db = int(getattr(pipeline.settings, "device_batch", 1) or 1)
    ordered = sort_files(paths)
    if db <= 1:
        for p in ordered:
            report.add(p, pipeline.process_file(p, force=force))
        return report

    # calibration frames first (they feed the masters), one at a time
    objects = []
    for p in ordered:
        try:
            t = str(read_fits(p)[0][1].get("IMAGETYP",
                                           "object")).strip().lower()
        except Exception:
            t = "object"
        if t == "object":
            objects.append(p)
        else:
            report.add(p, pipeline.process_file(p, force=force))
    _run_batched_objects(pipeline, objects, db, report, force)
    return report


def _run_batched_objects(pipeline, paths, db: int, report: RunReport,
                         force: bool) -> None:
    """Device-batched science reduction: calibrate+extract over frame
    stacks split across devices, host publication per frame."""
    import numpy as np
    import torch

    from blackbox_tpu_torch.orchestration.paths import night_date
    from blackbox_tpu_torch.parallel.mesh import (make_batched_reduce,
                                                  make_mesh)

    ctx = pipeline.ctx
    geom = pipeline.geom
    xt = pipeline.xtalk
    nl = pipeline.nonlin_coeffs

    # group by (night date, filter): those share masters and BPM
    groups: dict = {}
    for p in paths:
        try:
            _, h = read_fits(p)[0]
            d = night_date(float(h.get("MJD-OBS", 60000.0))
                           if "MJD-OBS" in h else str(h["DATE-OBS"]),
                           pipeline.site[1])
            f = str(h.get("FILTER", "q")).strip()
            groups.setdefault((d, f), []).append(p)
        except Exception:
            report.add(p, pipeline.process_file(p, force=force))

    # the pipeline's device, or every card when it runs on one
    dev = pipeline.device
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    ndev = len(devices)
    for (d, f), group in groups.items():
        mb, _ = pipeline.masters.ensure_master("bias", d, geom) \
            if ctx.subtract_mbias else (None, None)
        mf, _ = pipeline.masters.ensure_master("flat", d, geom, filt=f)
        mbias = None if mb is None else geom.disassemble(
            torch.as_tensor(np.asarray(mb, np.float32), device=dev))
        mflat = None if mf is None else geom.disassemble(
            torch.as_tensor(np.asarray(mf, np.float32), device=dev))
        bpm = pipeline._load_bpm(f)

        for b0 in range(0, len(group), db):
            chunk = group[b0:b0 + db]
            stacks, ok_paths = [], []
            for p in chunk:
                try:
                    raw, _h = read_fits(p)[0]
                    stacks.append(geom.split_raw(pipeline._upload_raw(raw)))
                    ok_paths.append(p)
                except Exception:
                    report.add(p, pipeline.process_file(p, force=force))
            if not ok_paths:
                continue
            batch = tuple(torch.stack([s[k] for s in stacks])
                          for k in range(3))
            del stacks
            # the mesh must divide the batch axis exactly: a partial
            # last chunk (e.g. 6 frames on 4 devices) takes the largest
            # divisor
            n = len(ok_paths)
            nmesh = max(k for k in range(1, min(ndev, n) + 1)
                        if n % k == 0)
            try:
                outs = make_batched_reduce(
                    ctx, make_mesh(nmesh, 1, devices))(
                    *batch, mbias, mflat, bpm, xt, nl)
            except Exception:
                # a device-side batch failure must not abort the night:
                # contain it to this chunk and fall back per frame
                log.exception("batched reduce failed for %d frames; "
                              "falling back to per-frame processing",
                              len(ok_paths))
                report.batch_fallbacks += len(ok_paths)
                for p in ok_paths:
                    report.add(p, pipeline.process_file(p, force=force))
                continue
            del batch
            for p, out in zip(ok_paths, outs):
                if out is None:
                    # another rank's frame (under a process group)
                    continue
                ext = out["ext"]
                # the calibration's own statistics: the merged dict
                # less the extraction's
                stats = {k: v for k, v in out["stats"].items()
                         if k not in ext["stats"]}
                report.add(p, pipeline.process_file(
                    p, force=force,
                    device_override={"sci": out["image"],
                                     "mask": out["mask"], "stats": stats,
                                     "ext": ext}))


def run_night(pipeline, date: str, *,
              until: Optional[Callable[[], bool]] = None,
              sunrise_margin_h: float = 1.0,
              poll_s: float = 2.0, max_runtime_s: Optional[float] = None,
              read_path: Optional[str] = None) -> RunReport:
    """Streaming night mode: watch the raw dir, reduce on arrival.

    Runs until ``until()`` is true (default: the sun is up by
    ``sunrise_margin_h`` hours at the pipeline's site) AND the queue has
    drained — the reference keeps reducing frames that arrived before
    sunrise+1h (blackbox.py:444-453).  ``read_path`` watches an
    alternative directory (reference --read_path).
    """
    raw_dir = read_path or pipeline.tree.raw_dir(date)
    q: "queue.Queue[str]" = queue.Queue()
    watcher = DirectoryWatcher(raw_dir + "/*.fits*", q, poll_s=poll_s,
                               preload_existing=True).start()
    t0 = time.time()
    site = pipeline.site
    lat, lon = site[0], site[1]
    height = site[2] if len(site) > 2 else 0.0
    # refraction + elevation-dip adjusted horizon, as the reference's
    # adjust_horizon (blackbox.py:403-412, 488-503)
    from blackbox_tpu_torch.astro.ephem import horizon_dip_deg
    dip = horizon_dip_deg(height)

    def default_until():
        if max_runtime_s is not None and time.time() - t0 > max_runtime_s:
            return True
        import datetime
        mjd = datetime2mjd(datetime.datetime.now(datetime.timezone.utc))
        # the sun rose (above the adjusted horizon) >= margin hours ago
        return sun_altitude(mjd - sunrise_margin_h / 24.0, lat, lon) > dip

    report = RunReport()
    try:
        drain_until(q, lambda p: report.add(p, pipeline.process_file(p)),
                    until or default_until)
    finally:
        watcher.stop()
    return report


def create_masters(pipeline, date: str, imgtypes=("bias", "flat"),
                   filters=("q",)) -> dict:
    """Bulk master creation for a date (reference create_masters,
    blackbox.py:617-782): every master is built from the already-reduced
    individual calibration frames in the red tree.  ``settings.nproc``
    workers overlap the host-side FITS IO of independent masters (the
    reference pools master_prep over nproc processes, blackbox.py:774).
    """
    jobs = []
    for imgtype in imgtypes:
        if imgtype == "flat":
            jobs += [(imgtype, f) for f in filters]
        else:
            jobs.append((imgtype, None))

    def build(key):
        imgtype, f = key
        data, h = pipeline.masters.ensure_master(
            imgtype, date, pipeline.geom, filt=f)
        return key, (h if data is not None else None)

    nproc = int(getattr(pipeline.settings, "nproc", 1) or 1)
    if nproc > 1 and len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nproc) as ex:
            return dict(ex.map(build, jobs))
    return dict(build(j) for j in jobs)
