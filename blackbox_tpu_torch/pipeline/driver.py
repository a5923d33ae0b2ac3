"""Per-frame host driver: raw FITS file -> published products (port of
:mod:`blackbox_tpu.pipeline.driver`).

The flow and its guarantees are the JAX package's:

  header checks -> raw QC gate -> skip/resume logic -> calibration ->
  red+mask products -> full QC (red => dummy catalogs) -> astrometry ->
  photometric calibration -> source catalog -> (vs a reference image)
  ZOGY subtraction -> transient catalog -> product publication

with every stage try/except-contained and stamped as a ``*-P`` boolean
header flag, so one bad frame never takes down a night.  The pixel work
runs on ``device`` (the card unless the caller asks for another): the
raw mosaic goes there once and is split there, the masters and the
bad-pixel mask go there as channel stacks, and calibration, extraction
and the subtraction run eagerly there through the port's kernels.  Each
boundary back to the host (FITS and Rice products, catalogs, header
statistics) converts with ``.cpu()``.

The solar-system matching (``sso_elements``, ``mpcorb_file``) and the
blind astrometric solve (``blind_index``) are host code, as in the JAX
package.  Not in this port yet, and refused with
``NotImplementedError`` naming the missing module when asked for: the
U-Net trail segmentation (``trailnet_params``, or ``use_unet_sat`` with
``sat_model_path``), the real/bogus network (``vetnet_params``) and the
batched runner's precomputed device work
(``process_file(device_override=...)``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from blackbox_tpu_torch.astro.astrometry import solve_tan
from blackbox_tpu_torch.astro.photcal import (
    fit_zeropoint, limiting_magnitude, match_catalogs)
from blackbox_tpu_torch.astro.wcs import TanWCS
from blackbox_tpu_torch.config.base import get_par
from blackbox_tpu_torch.config.defaults import ReductionSettings
from blackbox_tpu_torch.io.fits import Header, read_fits, write_image
from blackbox_tpu_torch.io.psffits import write_psf
from blackbox_tpu_torch.io.rice import read_rice, write_rice
from blackbox_tpu_torch.io.storage import get_backend, list_files
from blackbox_tpu_torch.orchestration.manifest import plan_tasks
from blackbox_tpu_torch.orchestration.masterstore import (MasterPolicy,
                                                          MasterStore)
from blackbox_tpu_torch.orchestration.paths import (
    DataTree, base_name, night_date)
from blackbox_tpu_torch.pipeline.catalogs import (
    device_cat_to_columns, write_catalog, write_dummy_catalog)
from blackbox_tpu_torch.pipeline.headers import (
    check_header_basic, set_header, stamp_calibration, stamp_extraction)
from blackbox_tpu_torch.pipeline.reduce import (
    ReduceContext, calibrate_detector, extract_catalog, to_device)
from blackbox_tpu_torch.qc.engine import run_qc_check
from blackbox_tpu_torch.utils.timing import timer

log = logging.getLogger(__name__)

# timing spans of one frame (FrameResult.timing), in seconds: the two
# device steps (synchronised), the masters' lookup (and build, on the
# first frame that needs one: read the night's frames, stack them on
# the device, publish), and the largest host steps
SPAN_CALIB = "device: calibrate+extract"
SPAN_SUBTRACT = "device: run_subtraction"
SPAN_MASTERS = "masters"
SPAN_READ = "host: raw read"
SPAN_RICE = "host: Rice writes"
SPAN_REF = "host: reference read"
SPAN_COMPONENTS = "host: mask components"


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _not_ported(what: str, module: str):
    return NotImplementedError(
        f"{what} needs {module}, which blackbox_tpu_torch does not port "
        "yet")


@dataclasses.dataclass
class FrameResult:
    status: str                 # reduced | skipped | rejected | error
    qc_flag: str = "green"
    products: list = dataclasses.field(default_factory=list)
    header: Optional[Header] = None
    stats: dict = dataclasses.field(default_factory=dict)
    error: Optional[str] = None
    # seconds: "wall" (the whole process_file call) and the spans
    # SPAN_CALIB, SPAN_SUBTRACT (synchronised device steps) and
    # SPAN_MASTERS
    timing: dict = dataclasses.field(default_factory=dict)


class Pipeline:
    """Stateful per-telescope pipeline: device callables + master store.

    ref_catalog : optional callable (ra, dec, radius_deg) ->
        dict(ra=…, dec=…, mag=…) supplying calibration stars.
    device : where the pixel work runs ("cuda" unless the caller asks
        for another, e.g. "cpu", where every kernel takes its plain
        PyTorch version).
    The ``compile_cache`` setting configures XLA's compilation cache in
    the JAX package; it means nothing to PyTorch and is ignored here.
    """

    def __init__(self, tree: DataTree, telescope: str = "ML1",
                 settings: Optional[ReductionSettings] = None,
                 ctx: Optional[ReduceContext] = None,
                 ref_catalog: Optional[Callable] = None,
                 ext_coeff: float = 0.0, subtract_refs: bool = True,
                 sso_elements: Optional[list] = None,
                 update_headertables: bool = True,
                 trailnet_params=None, vetnet_params=None,
                 blind_index=None, xtalk_coeffs=None, field_grid=None,
                 device="cuda"):
        self.tree = tree
        self.telescope = telescope
        self.device = torch.device(device)
        self.settings = settings or ReductionSettings()
        if trailnet_params is not None or (
                getattr(self.settings, "use_unet_sat", False)
                and getattr(self.settings, "sat_model_path", None)):
            raise _not_ported("the U-Net trail segmentation",
                              "models/trailnet.py")
        if vetnet_params is not None:
            raise _not_ported("real/bogus scoring", "models/vetnet.py")
        self.ctx = ctx or ReduceContext.from_settings(
            self.settings, telescope)
        self.geom = self.ctx.geom
        self.site = get_par(self.settings.site, telescope)
        self.masters = MasterStore(tree, telescope, MasterPolicy(
            cal_window=dict(self.settings.cal_window),
            ncal_max=dict(self.settings.ncal_max),
            flat_reject_eve=bool(get_par(self.settings.flat_reject_eve,
                                         telescope)),
            create=bool(get_par(self.settings.create_master,
                                telescope))), device=self.device)
        self.ref_catalog = ref_catalog
        self.ext_coeff = ext_coeff
        self.subtract_refs = subtract_refs
        self.update_headertables = update_headertables
        self.sso_elements = sso_elements or []
        # MPCORB ingestion: a settings path loads the orbit catalog
        mpcorb = getattr(self.settings, "mpcorb_file", None)
        if not self.sso_elements and mpcorb:
            try:
                from blackbox_tpu_torch.sso.mpcorb import parse_mpcorb
                self.sso_elements = parse_mpcorb(mpcorb)
            except OSError:
                log.warning("mpcorb_file %s unreadable; SSO matching off",
                            mpcorb)
        # survey field grid {field_id: (ra, dec)} for the RADECOFF
        # pointing check
        self.field_grid = field_grid
        # optional QuadIndex for the blind-solve fallback when the
        # seeded solve fails (lost pointing)
        self.blind_index = blind_index

        # crosstalk coefficients: explicit array > settings file > off
        if xtalk_coeffs is not None:
            self.xtalk = np.asarray(xtalk_coeffs, np.float32)
        elif getattr(self.settings, "xtalk_file", None):
            from blackbox_tpu_torch.ops.xtalk import load_coeff_file
            self.xtalk = load_coeff_file(
                self._cal_path(self.settings.xtalk_file),
                self.geom.n_chan).astype(np.float32)
        else:
            self.xtalk = None

        # non-linearity coefficients: (C, D) fractional-correction
        # polynomial from the calibration store
        self.nonlin_coeffs = None
        if self.ctx.correct_nonlin and \
                getattr(self.settings, "nonlin_corr_file", None):
            try:
                p = self._cal_path(self.settings.nonlin_corr_file)
                if str(p).endswith(".pkl"):
                    # reference production format: pickled per-channel
                    # scipy splines, converted in place
                    from blackbox_tpu_torch.ops.nonlin import (
                        convert_reference_splines)
                    self.nonlin_coeffs, err = convert_reference_splines(p)
                    log.info("converted nonlin splines %s (max |dfrac| "
                             "%.1e)", p, err)
                else:
                    self.nonlin_coeffs = np.load(p).astype(np.float32)
            except Exception:
                log.exception("could not load non-linearity coefficients "
                              "from %s", self.settings.nonlin_corr_file)

        # static per-filter bad-pixel masks (device channel stacks),
        # loaded lazily per filter
        self._bpm_cache = {}
        self._spans = {}

        ctx_ = self.ctx
        xt = to_device(self.xtalk, self.device)
        nl = to_device(self.nonlin_coeffs, self.device)

        @torch.inference_mode()
        def _calibrate(c, v, h, mb, mf, bpm):
            return calibrate_detector(ctx_, c, v, h, mb, mf, bpm, xt, nl)

        # calibration frames: no crosstalk (the reference's bias/flat
        # early returns happen before its crosstalk correction)
        @torch.inference_mode()
        def _calibrate_cal(c, v, h, mb, mf, bpm):
            return calibrate_detector(ctx_, c, v, h, mb, mf, bpm, None, nl)

        @torch.inference_mode()
        def _extract(s, m):
            return extract_catalog(ctx_, s, m)

        # science frames: calibration then extraction in one call; the
        # QC red => dummy gate then discards the extraction of a red
        # frame, which is rare
        @torch.inference_mode()
        def _reduce_sci(c, v, hh, mb, mf, bpm):
            sci, mask_m, stats = calibrate_detector(
                ctx_, c, v, hh, mb, mf, bpm, xt, nl)
            return sci, mask_m, stats, extract_catalog(ctx_, sci, mask_m)

        self._calibrate = _calibrate
        self._calibrate_cal = _calibrate_cal
        self._extract = _extract
        self._reduce_sci = _reduce_sci

    def _cal_path(self, p: str) -> str:
        """Resolve a calibration-file path against cal_dir when
        relative."""
        cal_dir = getattr(self.settings, "cal_dir", None)
        if cal_dir and not os.path.isabs(str(p)) and "://" not in str(p):
            return os.path.join(str(cal_dir), str(p))
        return str(p)

    def _load_bpm(self, filt: str):
        """(C, ych, xch) uint8 static bad-pixel mask on the device for a
        filter, or None.  ``bad_pixel_mask`` may be one path or a
        per-filter dict."""
        spec = getattr(self.settings, "bad_pixel_mask", None)
        if spec is None:
            return None
        path = spec.get(filt) if isinstance(spec, dict) else spec
        if not path:
            return None
        path = self._cal_path(path)
        if path not in self._bpm_cache:
            try:
                hdus = read_fits(path)
                data = next(d for d, _ in hdus if d is not None
                            and not isinstance(d, dict))
                self._bpm_cache[path] = self.geom.disassemble(
                    torch.as_tensor(np.asarray(data).astype(np.uint8),
                                    device=self.device))
            except Exception:
                log.exception("could not load bad-pixel mask %s", path)
                self._bpm_cache[path] = None
        return self._bpm_cache[path]

    def _rice(self, path, data, h, qlevel):
        """write_rice, timed into SPAN_RICE."""
        with timer(SPAN_RICE, spans=self._spans):
            write_rice(path, data, h, qlevel=qlevel)

    def _upload_raw(self, raw):
        """The raw mosaic on the device as float32: unsigned 16-bit
        frames cross as 2 bytes a pixel and widen there."""
        if raw.dtype == np.dtype(np.uint16):
            t = torch.from_numpy(np.ascontiguousarray(raw).view(np.int16))
            t = t.to(self.device)
            return (t.to(torch.int32) & 0xFFFF).to(torch.float32)
        return torch.as_tensor(np.asarray(raw, np.float32),
                               device=self.device)

    # ------------------------------------------------------------ entry

    def process_file(self, path: str, force: bool = False,
                     img_reduce: bool = True, cat_extract: bool = True,
                     trans_extract: bool = True,
                     device_override=None) -> FrameResult:
        if device_override is not None:
            raise _not_ported("precomputed device work (device_override)",
                              "the batched scheduler "
                              "(orchestration/scheduler.py)")
        t0 = time.time()
        self._spans = {}
        try:
            res = self._process(path, force, img_reduce, cat_extract,
                                trans_extract)
        except Exception as e:          # frame-level containment
            log.exception("frame %s failed", path)
            res = FrameResult(status="error",
                              error=f"{type(e).__name__}: {e}")
        res.timing = dict(self._spans, wall=time.time() - t0)
        log.info("%s done in %.1f s", os.path.basename(path),
                 res.timing["wall"])
        return res

    def _process(self, path, force, img_reduce, cat_extract,
                 trans_extract) -> FrameResult:
        dev = self.device
        try:
            with timer(SPAN_READ, spans=self._spans):
                hdus = read_fits(path)
            raw, h = hdus[0]
        except Exception as e:
            return FrameResult(status="rejected",
                               error=f"unreadable FITS file: {e}")
        if raw is None:
            return FrameResult(status="rejected",
                               error="no image data in primary HDU")
        problems = check_header_basic(h)
        if problems:
            return FrameResult(status="rejected",
                               error="; ".join(problems))
        h = set_header(h, self.site, field_grid=self.field_grid,
                       tel=self.telescope)
        # raw QC gate (red => abort)
        flag = run_qc_check(h, self.telescope, check_key_type="raw")
        if flag == "red":
            return FrameResult(status="rejected", qc_flag="red", header=h)

        imgtype = str(h["IMAGETYP"]).strip().lower()
        date = night_date(float(h["MJD-OBS"]), self.site[1])
        base = base_name(path)
        filt = str(h["FILTER"]).strip()

        plan = plan_tasks(self.tree, date, path, img_reduce, cat_extract,
                          trans_extract, force, imgtype=imgtype)
        if not plan:
            return FrameResult(status="skipped", header=h)

        # granular resume: when the _red products already exist and only
        # the catalog/transient stages are missing, reuse the published
        # image instead of recalibrating from raw
        reused = None
        fused_ext = None          # set by the fused science call
        if imgtype == "object" and "img_reduce" not in plan:
            reused = self._load_published_red(date, base)
        if reused is not None:
            sci_np, mask_np, h = reused
            h["RED-REUSED"] = (True, "published _red products reused?")
            sci = torch.as_tensor(sci_np, device=dev)
            mask = torch.as_tensor(mask_np, device=dev)
            stats = {}
            rdir = self.tree.red_dir(date, imgtype)
            products = []

            def ship_log(result_line: str):
                lg = os.path.join(rdir, base + "_red.log")
                lines = [f"{time.strftime('%Y-%m-%dT%H:%M:%S')} "
                         f"{os.path.basename(path)} [{imgtype}/{filt}] "
                         f"{result_line}"]
                get_backend(lg).write_bytes(
                    lg, "\n".join(lines).encode() + b"\n")
                products.append(lg)
            exptime = float(h.get("EXPTIME", 1.0))
            pixscale = self.settings.pixscale
        else:
            # ---- calibration: the raw mosaic goes to the device once
            # and is split there ----
            chan, osv, osh = self.geom.split_raw(self._upload_raw(raw))
            del raw

            def _master_keys(tag: str, mh):
                # provenance of the master applied (MBIAS-F / MB-NDAYS,
                # MFLAT-F / MF-NDAYS)
                if mh is None:
                    return
                if "MASTERF" in mh:
                    h[f"M{tag}-F"] = (str(mh["MASTERF"]),
                                      f"master {tag.lower()} applied")
                if "MDATE" in mh:
                    try:
                        d0 = datetime.date(int(date[:4]), int(date[4:6]),
                                           int(date[6:8]))
                        md = str(mh["MDATE"])
                        d1 = datetime.date(int(md[:4]), int(md[4:6]),
                                           int(md[6:8]))
                        h[f"M{tag[0]}-NDAYS"] = (
                            abs((d0 - d1).days),
                            f"[days] age of master {tag.lower()}")
                    except (ValueError, TypeError):
                        pass

            def _to_chan(m):
                return self.geom.disassemble(torch.as_tensor(
                    np.asarray(m, np.float32), device=dev))

            h["MBIAS-P"] = (False, "corrected for master bias?")
            h["MFLAT-P"] = (False, "corrected for master flat?")
            h["NONLIN-P"] = (self.nonlin_coeffs is not None,
                             "corrected for non-linearity?")
            mbias = mflat = None
            with timer(SPAN_MASTERS, sync=dev, spans=self._spans):
                if imgtype in ("object", "flat", "dark") and \
                        self.ctx.subtract_mbias:
                    mb, mbh = self.masters.ensure_master("bias", date,
                                                         self.geom)
                    if mbh is not None:
                        if mb is not None:
                            mbias = _to_chan(mb)
                        h["MBIAS-P"] = True
                        _master_keys("BIAS", mbh)
                if imgtype == "object":
                    mf, mfh = self.masters.ensure_master(
                        "flat", date, self.geom, filt=filt)
                    if mfh is not None:
                        if mf is not None:
                            mflat = _to_chan(mf)
                        h["MFLAT-P"] = True
                        _master_keys("FLAT", mfh)

            # static per-filter bad-pixel mask
            bpm = None
            if imgtype in ("object", "flat"):
                bpm = self._load_bpm(filt)
                if bpm is not None:
                    h["BPM-F"] = (os.path.basename(
                        str(self.settings.bad_pixel_mask.get(filt)
                            if isinstance(self.settings.bad_pixel_mask, dict)
                            else self.settings.bad_pixel_mask)),
                        "static bad-pixel mask applied")

            with timer(SPAN_CALIB, sync=dev, spans=self._spans):
                if imgtype == "object" and cat_extract:
                    # calibration + extraction in one call; on a QC-red
                    # frame the speculative extraction is discarded
                    sci, mask, stats, fused_ext = self._reduce_sci(
                        chan, osv, osh, mbias, mflat, bpm)
                elif imgtype == "object":
                    sci, mask, stats = self._calibrate(
                        chan, osv, osh, mbias, mflat, bpm)
                else:
                    sci, mask, stats = self._calibrate_cal(
                        chan, osv, osh, mbias, mflat, bpm)
            del chan, osv, osh, mbias, mflat
            stats = {k: _host(v) for k, v in stats.items()}
            sci_np = _host(sci).astype(np.float32, copy=False)
            mask_np = _host(mask).astype(np.uint8, copy=False)

            # exact component counts on the host (the device-side Euler
            # estimate needs hole-free masks); the mask is fetched for
            # writing anyway
            try:
                from scipy import ndimage
                from blackbox_tpu_torch.core import maskbits as mb
                eight = np.ones((3, 3), np.int8)
                with timer(SPAN_COMPONENTS, spans=self._spans):
                    stats["ncosmics"] = ndimage.label(
                        (mask_np & mb.COSMIC) != 0, eight)[1]
                    stats["nobj_sat"] = ndimage.label(
                        (mask_np & mb.SATURATED) != 0, eight)[1]
            except ImportError:
                pass

            exptime = float(h["EXPTIME"]) if imgtype == "object" else 1.0
            pixscale = self.settings.pixscale
            stamp_calibration(h, stats, self.ctx.gains, pixscale, exptime)
            h["OS-P"] = (True, "overscan corrected?")
            h["GAIN-P"] = (True, "gain corrected?")
            h["XTALK-P"] = (self.xtalk is not None and imgtype == "object",
                            "corrected for crosstalk?")
            h["MASK-P"] = (True, "mask built?")
            h["COSMIC-P"] = (True, "cosmic rays rejected?")
            h["SAT-P"] = (bool(self.ctx.detect_sats), "satellites detected?")

            rdir = self.tree.red_dir(date, imgtype)
            get_backend(rdir).make_dir(rdir)
            products = []

            def ship_log(result_line: str):
                # per-image logfile shipped with the products
                lg = os.path.join(rdir, base + "_red.log")
                lines = [f"{time.strftime('%Y-%m-%dT%H:%M:%S')} "
                         f"{os.path.basename(path)} [{imgtype}/{filt}] "
                         f"{result_line}"]
                for k in ("QC-FLAG", "RDNOISE", "NCOSMICS", "NSATS",
                          "NOBJECTS", "S-SEEING", "PC-ZP", "LIMMAG",
                          "T-NTRANS"):
                    if k in h:
                        lines.append(f"  {k} = {h[k]}")
                get_backend(lg).write_bytes(lg, "\n".join(lines).encode()
                                            + b"\n")
                products.append(lg)

            # calibration frames: publish and return
            if imgtype in ("bias", "dark", "flat"):
                if imgtype == "flat":
                    # flat-field quality statistics
                    from blackbox_tpu_torch.ops.flatstats import \
                        flat_statistics
                    from blackbox_tpu_torch.pipeline.headers import \
                        stamp_flatstats
                    H, W = self.geom.red_shape
                    statsec = (slice(H // 2 - H // 8, H // 2 + H // 8),
                               slice(W // 2 - W // 8, W // 2 + W // 8))
                    subsize = max(min(H, W) // 8, 8)
                    with torch.inference_mode():
                        fs = flat_statistics(sci, mask, self.geom, statsec,
                                             subsize)
                    stamp_flatstats(h, {k: _host(v) for k, v in fs.items()})
                del sci, mask
                run_qc_check(h, self.telescope, check_key_type=imgtype)
                red = os.path.join(rdir, base + "_red.fits.fz")
                # q=16 like every non-special float product
                self._rice(red, sci_np, h, 16.0)
                products.append(red)
                self._quicklook(red, sci_np, h, products)
                if self.update_headertables and imgtype in ("bias", "flat"):
                    from blackbox_tpu_torch.orchestration.headertable \
                        import add_headkeys
                    add_headkeys(self.tree, self.telescope, imgtype, [h],
                                 [base + "_red.fits"])
                if imgtype == "dark" and \
                        bool(get_par(self.settings.create_mdark,
                                     self.telescope)):
                    # master dark for the evening (exposure-time-
                    # normalised stack)
                    try:
                        self.masters.ensure_master("dark", date, self.geom)
                    except Exception:
                        log.exception("master dark creation failed")
                ship_log("reduced (calibration frame)")
                return FrameResult(status="reduced",
                                   qc_flag=str(h["QC-FLAG"]).strip(),
                                   products=products, header=h, stats=stats)

        # ---- source extraction ----
        ext = fused_ext
        if ext is None:
            with timer(SPAN_CALIB, sync=dev, spans=self._spans):
                ext = self._extract(sci, mask)
        estats = {k: _host(v) for k, v in ext["stats"].items()}
        stamp_extraction(h, estats, pixscale)
        h["S-P"] = (True, "source extraction succeeded?")
        h["PSF-P"] = (self.ctx.fit_psf, "PSF fitted?")
        if "psf_nstars" in estats:
            h["PSF-NOBJ"] = (int(estats["psf_nstars"]),
                             "stars used in PSF fit")
        if "psf_fwhm_pix" in estats:
            h["PSF-FWHM"] = (round(float(estats["psf_fwhm_pix"])
                                   * pixscale, 3), "[arcsec] PSF FWHM")
            h["PSF-CHI2"] = (round(float(estats["psf_chi2"]), 3),
                             "PSF fit median chi2")

        cat = {k: _host(v) for k, v in ext["cat"].items()}

        # ---- astrometry: seeded TAN solve against the ref catalog ----
        wcs = TanWCS.simple(float(h.get("RA", 150.0)),
                            float(h.get("DEC", -30.0)),
                            pixscale, sci_np.shape)
        h["A-P"] = (False, "astrometry solved?")
        h["PC-P"] = (False, "photometrically calibrated?")
        zp = None
        if self.ref_catalog is not None:
            radius = 1.2 * pixscale * max(sci_np.shape) / 3600.0
            refcat = self.ref_catalog(wcs.crval1, wcs.crval2, radius)
            sel = cat["valid"]
            sol = solve_tan(cat["x"][sel], cat["y"][sel],
                            cat["flux_iso"][sel],
                            refcat["ra"], refcat["dec"], refcat["mag"],
                            wcs)
            if not sol.ok and self.blind_index is not None:
                # lost pointing: blind quad-hash solve
                from blackbox_tpu_torch.astro.blindsolve import blind_solve
                sol = blind_solve(cat["x"][sel], cat["y"][sel],
                                  cat["flux_iso"][sel],
                                  self.blind_index, sci_np.shape,
                                  pixscale_hint=pixscale)
                if sol.ok:
                    h["A-BLIND"] = (True,
                                    "WCS from blind quad-hash solve")
                    refcat = self.ref_catalog(sol.wcs.crval1,
                                              sol.wcs.crval2, radius)
            if sol.ok:
                wcs = sol.wcs
                h["A-P"] = True
                h["A-NAST"] = (sol.nmatch, "astrometric matches")
                h["A-RMS"] = (round(sol.rms_arcsec, 4),
                              "[arcsec] astrometric rms")
                # ---- photometric calibration: bright, unblended stars
                # only (faint detections carry Eddington bias) ----
                cal = sel & (cat["snr"] > 20) & (cat["elong"] < 1.5)
                # isolation: drop stars with ANY detection within 12 px
                ax, ay = cat["x"][sel], cat["y"][sel]
                cx_, cy_ = cat["x"][cal], cat["y"][cal]
                # chunked: the dense (Ncal, Nsel) matrix reaches
                # multi-GB at the 20k-source capacity on crowded fields
                nnear = np.empty(len(cx_), np.int64)
                for c0 in range(0, len(cx_), 1024):
                    cs = slice(c0, c0 + 1024)
                    d2n = ((cx_[cs, None] - ax[None, :]) ** 2
                           + (cy_[cs, None] - ay[None, :]) ** 2)
                    nnear[cs] = np.sum(d2n < 12.0 ** 2, axis=1)  # incl self
                iso = np.zeros_like(cal)
                iso[np.flatnonzero(cal)] = nnear <= 1
                if iso.sum() >= 5:
                    cal = iso
                rx, ry = wcs.sky2pix(refcat["ra"], refcat["dec"])
                ii, jj = match_catalogs(cat["x"][cal], cat["y"][cal],
                                        rx, ry, radius_pix=2.0)
                flux_key = "flux_psf" if "flux_psf" in cat else "flux_iso"
                zp_fit = fit_zeropoint(
                    cat[flux_key][cal][ii],
                    None, np.asarray(refcat["mag"])[jj], exptime,
                    airmass=float(h.get("AIRMASS", 1.0)),
                    ext_coeff=self.ext_coeff)
                if zp_fit.ok:
                    zp = zp_fit.zp
                    h["PC-P"] = (True, "photometrically calibrated?")
                    h["PC-ZP"] = (round(zp, 4), "[mag] zeropoint")
                    h["PC-ZPSTD"] = (round(zp_fit.zp_std, 4),
                                     "[mag] zeropoint STD")
                    h["PC-NCAL"] = (zp_fit.nstars, "calibration stars")
                    limmag = limiting_magnitude(
                        zp, float(estats["bkg_std"]),
                        float(estats["s_seeing_pix"]), exptime,
                        airmass=float(h.get("AIRMASS", 1.0)),
                        ext_coeff=self.ext_coeff)
                    h["LIMMAG"] = (round(limmag, 4),
                                   "[mag] 5-sigma limiting magnitude")
        if zp is None:
            # photometric calibration unavailable: the per-filter
            # default zeropoint for the depth estimate; PC-P stays False
            zp_def = self.settings.zp_default
            zp0 = zp_def.get(filt) if isinstance(zp_def, dict) else zp_def
            if zp0 is not None and "bkg_std" in estats:
                h["PC-ZPDEF"] = (True, "default zeropoint used?")
                limmag = limiting_magnitude(
                    float(zp0), float(estats["bkg_std"]),
                    float(estats["s_seeing_pix"]), exptime,
                    airmass=float(h.get("AIRMASS", 1.0)),
                    ext_coeff=self.ext_coeff)
                h["LIMMAG"] = (round(limmag, 4),
                               "[mag] 5-sigma limiting magnitude "
                               "(default ZP)")
        wcs.to_header(h)

        # ---- full-frame QC; red => dummy catalogs ----
        h["DUMCAT"] = (False, "dummy catalog without sources?")
        flag = run_qc_check(h, self.telescope, check_key_type="full")

        # header contract enforcement BEFORE shipping
        from blackbox_tpu_torch.pipeline.headers import verify_header
        problems = verify_header(h, "full")
        if problems:
            if reused is not None:
                # products published by an OLDER pipeline version can
                # miss newly-required keywords: recalibrate from raw
                log.warning("reused _red header fails the current "
                            "contract (%s); recalibrating from raw",
                            "; ".join(problems[:3]))
                return self._process(path, True, True, cat_extract,
                                     trans_extract)
            raise RuntimeError(
                "header contract violated, not shipping: "
                + "; ".join(problems[:8]))

        red = os.path.join(rdir, base + "_red.fits.fz")
        mask_p = os.path.join(rdir, base + "_mask.fits.fz")
        hdr_p = os.path.join(rdir, base + "_red_hdr.fits")
        cat_p = os.path.join(rdir, base + "_red_cat.fits")
        if reused is None:
            self._rice(red, sci_np, h, 16.0)
            self._rice(mask_p, mask_np.astype(np.uint8), h, 16.0)
            products += [red, mask_p]
            self._quicklook(red, sci_np, h, products)
        # the header product always refreshes; the PIXEL products never
        # rewrite on the reuse path (re-encoding decompressed q=16 data
        # would compound Rice quantisation noise)
        write_image(hdr_p, None, h)
        products.append(hdr_p)

        if flag == "red":
            write_dummy_catalog(cat_p, h, "new", self.telescope)
            products.append(cat_p)
            if self.update_headertables:
                # red frames stay in the index so buildref's QC cut can
                # see (and reject) them
                from blackbox_tpu_torch.orchestration.headertable import \
                    add_headkeys
                add_headkeys(self.tree, self.telescope, "cat", [h],
                             [base + "_red.fits"])
            ship_log("reduced red-flagged (dummy catalog)")
            return FrameResult(status="reduced", qc_flag="red",
                               products=products, header=h, stats=stats)

        # catalog products ship only when the plan asked for them
        if "cat_extract" in plan:
            cols = device_cat_to_columns(
                cat, zp, airmass=float(h.get("AIRMASS", 1.0)),
                ext_coeff=self.ext_coeff, wcs=wcs,
                n_aper=len(self.ctx.apphot_radii), exptime=exptime)
            write_catalog(cat_p, cols, h, "new")
            products.append(cat_p)
            psf_p = os.path.join(rdir, base + "_psf.fits")
            if "psf" in ext:
                write_psf(psf_p, ext["psf"], h)
                products.append(psf_p)

        # ---- transient extraction against the field reference ----
        # gated on the PLAN: finished transient products must not be
        # redone and overwritten on a resume
        if "trans_extract" in plan and self.subtract_refs:
            try:
                tr = self._transients(h, sci, ext, mask, wcs, cat, zp,
                                      rdir, base)
                products += tr
                h["TRANS-P"] = (bool(tr), "transients extracted?")
            except Exception:
                log.exception("subtraction failed for %s", base)
                h["TRANS-P"] = (False, "transients extracted?")
                h["TQC-FLAG"] = ("red", "transient QC flag")

        if self.update_headertables:
            from blackbox_tpu_torch.orchestration.headertable import \
                add_headkeys
            add_headkeys(self.tree, self.telescope, "cat", [h],
                         [base + "_red.fits"])
            if "T-NTRANS" in h:
                add_headkeys(self.tree, self.telescope, "trans", [h],
                             [base + "_red.fits"])
        ship_log("reduced")
        return FrameResult(status="reduced",
                           qc_flag=str(h["QC-FLAG"]).strip(),
                           products=products, header=h,
                           stats={**stats, **estats})

    def _load_published_red(self, date: str, base: str):
        """(sci, mask, header) from the published _red products, or
        None when any piece is missing/unreadable."""
        rdir = self.tree.red_dir(date, "object")
        try:
            sci, _ = read_rice(os.path.join(rdir, base + "_red.fits.fz"))
            mask, _ = read_rice(os.path.join(rdir,
                                             base + "_mask.fits.fz"))
            hdus = read_fits(os.path.join(rdir, base + "_red_hdr.fits"))
            h = max((hh for _, hh in hdus), key=lambda x: len(x.keys()))
            return (np.asarray(sci, np.float32),
                    np.asarray(mask, np.uint8), h)
        except Exception:
            log.info("published _red products unusable for %s; "
                     "recalibrating from raw", base)
            return None

    def _adopt_as_reference(self, h, sci, ext, mask, rdir, base,
                            field_id: int, filt: str) -> list:
        """Publish this frame's products as the field reference
        (create_ref semantics: background-subtracted image + mask +
        PSF + catalog + STD map under ref/<field>/)."""
        refdir = self.tree.ref_dir(field_id)
        get_backend(refdir).make_dir(refdir)
        date = night_date(float(h["MJD-OBS"]), self.site[1])
        stem = f"{self.telescope}_{field_id}_{filt}_{date}"
        sub = _host(sci - ext["bkg"]).astype(np.float32, copy=False)
        products = []
        p_img = os.path.join(refdir, stem + "_red.fits.fz")
        self._rice(p_img, sub, h, 16.0)
        self._rice(os.path.join(refdir, stem + "_mask.fits.fz"),
                   _host(mask).astype(np.uint8, copy=False), h, 16.0)
        self._rice(os.path.join(refdir, stem + "_bkgstd.fits.fz"),
                   _host(ext["bkg_std"]).astype(np.float32, copy=False), h,
                   qlevel=4.0)
        if "psf" in ext:
            write_psf(os.path.join(refdir, stem + "_psf.fits"),
                      ext["psf"], h)
        cat_src = os.path.join(rdir, base + "_red_cat.fits")
        try:
            be = get_backend(cat_src)
            be.write_bytes(os.path.join(refdir, stem + "_red_cat.fits"),
                           be.read_bytes(cat_src))
        except Exception:
            log.exception("could not copy catalog for adopted ref %s",
                          stem)
        h["REF-NEW"] = (True, "frame adopted as field reference")
        log.info("adopted %s as reference for field %d/%s", base,
                 field_id, filt)
        products.append(p_img)
        return products

    # ------------------------------------------------------ quicklooks

    def _quicklook(self, product_path: str, img, h, products: list):
        """jpg quicklook next to a pixel product (every shipped image
        gets one)."""
        if not getattr(self.settings, "make_quicklooks", True):
            return
        try:
            from blackbox_tpu_torch.report.quicklook import save_jpeg
            jpg = product_path.replace(".fits.fz", ".jpg").replace(
                ".fits", ".jpg")
            title = "{} {} {}".format(
                os.path.basename(product_path),
                h.get("DATE-OBS", ""), h.get("QC-FLAG", ""))
            save_jpeg(jpg, _host(img), title=title)
            products.append(jpg)
        except Exception:
            log.exception("quicklook failed for %s", product_path)

    # ------------------------------------------------------- subtraction

    def _find_ref(self, field_id: int, filt: str):
        rdir = self.tree.ref_dir(field_id)
        cands = [f for f in list_files(os.path.join(rdir, "*_red.fits*"))
                 if f"_{filt}_" in os.path.basename(f)
                 or f"_{filt}." in os.path.basename(f)]
        return cands[-1] if cands else None

    def _transients(self, h, sci, ext, mask, wcs, cat, zp, rdir, base):
        from blackbox_tpu_torch.io.psffits import read_psf
        from blackbox_tpu_torch.pipeline.subtract import (
            SubtractionInput, run_subtraction)

        dev = self.device
        try:
            field_id = int(h.get("OBJECT"))
        except (TypeError, ValueError):
            return []
        filt = str(h["FILTER"]).strip()
        ref_img_path = self._find_ref(field_id, filt)
        if ref_img_path is None:
            if bool(get_par(self.settings.create_ref, self.telescope)):
                # no reference yet: this image becomes the field's
                # reference
                return self._adopt_as_reference(h, sci, ext, mask, rdir,
                                                base, field_id, filt)
            return []
        ref_base = base_name(ref_img_path)[:-len("_red")]
        rd = os.path.dirname(ref_img_path)
        with timer(SPAN_REF, spans=self._spans):
            ref_img, ref_h = read_rice(ref_img_path)
            ref_mask, _ = read_rice(os.path.join(rd,
                                                 ref_base + "_mask.fits.fz"))
            ref_psf = read_psf(os.path.join(rd, ref_base + "_psf.fits"),
                               device=dev)
            ref_cat = read_fits(os.path.join(rd, ref_base + "_red_cat.fits"))
            rcols = next(d for d, hh in ref_cat if isinstance(d, dict))
            ref_wcs = TanWCS.from_header(ref_h)

            # ref background: stored images are background-subtracted
            # refs; the co-add ships its per-pixel STD map
            H, W = ref_img.shape
            std_p = os.path.join(rd, ref_base + "_bkgstd.fits.fz")
            try:
                ref_std = np.asarray(read_rice(std_p)[0], np.float32)
                ref_std = np.clip(ref_std, 1e-3, None)
            except Exception:
                ref_std = np.full((H, W),
                                  max(float(ref_h.get("S-BKGSTD", 10.0)),
                                      1e-3), np.float32)

        new_in = SubtractionInput(
            image=sci, bkg=ext["bkg"], bkg_std=ext["bkg_std"],
            mask=mask, psf=ext["psf"], wcs=wcs,
            cat_x=cat["x"], cat_y=cat["y"],
            cat_flux=cat.get("flux_psf", cat["flux_iso"]),
            cat_fluxerr=cat.get("fluxerr_psf",
                                np.ones_like(cat["flux_iso"])),
            cat_valid=cat["valid"])
        ref_t = torch.as_tensor(np.asarray(ref_img, np.float32), device=dev)
        ref_in = SubtractionInput(
            image=ref_t, bkg=torch.zeros_like(ref_t),
            bkg_std=torch.as_tensor(ref_std, device=dev),
            mask=torch.as_tensor(np.asarray(ref_mask, np.uint8), device=dev),
            psf=ref_psf, wcs=ref_wcs,
            cat_x=np.asarray(rcols["X_POS"], np.float64) - 1,
            cat_y=np.asarray(rcols["Y_POS"], np.float64) - 1,
            cat_flux=np.asarray(rcols["E_FLUX_OPT"], np.float64),
            cat_fluxerr=np.asarray(rcols["E_FLUXERR_OPT"], np.float64),
            cat_valid=np.ones(len(rcols["X_POS"]), bool))
        del ref_img, ref_mask, ref_std, ref_t

        with timer(SPAN_SUBTRACT, sync=dev, spans=self._spans):
            res = run_subtraction(new_in, ref_in)
        del new_in, ref_in
        for k, v in res.stats.items():
            key = {"z_fratio": "Z-FRATIO", "z_fratio_std": "Z-FRSTD",
                   "z_dxrms": "Z-DXRMS", "z_dyrms": "Z-DYRMS",
                   "z_scorr_std": "Z-SCSTD",
                   "t_ntrans": "T-NTRANS", "t_npos": "T-NPOS",
                   "t_nneg": "T-NNEG", "t_nvetted": "T-NVET"}.get(k)
            if key:
                h[key] = (round(float(v), 4) if isinstance(v, float)
                          else int(v), "")
        tflag = run_qc_check(h, self.telescope, check_key_type="trans",
                             flag_key="TQC-FLAG")
        from blackbox_tpu_torch.pipeline.headers import verify_header
        problems = verify_header(h, "trans")
        if problems:
            raise RuntimeError(
                "transient header contract violated: "
                + "; ".join(problems[:8]))

        products = []
        tcat_p = os.path.join(rdir, base + "_red_trans.fits")
        if tflag == "red":
            write_dummy_catalog(tcat_p, h, "trans", self.telescope)
            products.append(tcat_p)
            return products

        tc = {k: _host(v) for k, v in res.trans_cat.items()}
        sel = np.flatnonzero(tc["valid"])
        ra, dec = wcs.pix2sky(tc["x"][sel], tc["y"][sel])
        mag = np.full(len(sel), 99.0, np.float32)
        if zp is not None:
            pos = tc["flux_psf"][sel] > 0
            # same zeropoint convention as the source catalog: zp
            # includes the +k*airmass term, so the magnitude subtracts
            # it back
            mag[pos] = (zp - 2.5 * np.log10(
                tc["flux_psf"][sel][pos] / max(float(h["EXPTIME"]), 1e-9))
                - self.ext_coeff * float(h.get("AIRMASS", 1.0)))
        tcols = {
            "NUMBER": np.arange(1, len(sel) + 1, dtype=np.int32),
            "X_PEAK": (tc["x"][sel] + 1).astype(np.float32),
            "Y_PEAK": (tc["y"][sel] + 1).astype(np.float32),
            "RA_PSF_D": ra, "DEC_PSF_D": dec,
            "SNR_ZOGY": tc["scorr_peak"][sel].astype(np.float32),
            "E_FLUX_ZOGY": tc["flux_psf"][sel].astype(np.float32),
            "E_FLUXERR_ZOGY": tc["fluxerr_psf"][sel].astype(np.float32),
            "MAG_ZOGY": mag,
            "ELONG_ZOGY": tc["elong"][sel].astype(np.float32),
            "NPIX_ZOGY": tc["npix"][sel].astype(np.int32),
        }
        # (the real/bogus network is refused in __init__ until
        # models/vetnet.py is ported)

        # known-asteroid cross-match
        if self.sso_elements:
            from blackbox_tpu_torch.sso.match import annotate_transients
            tcols = annotate_transients(tcols, float(h["MJD-OBS"]),
                                        self.sso_elements,
                                        site=self.site)
            h["SSO-P"] = (True, "transients matched to known SSOs?")
            h["N-SSO"] = (int(np.sum(tcols["SSO_DESIG"] != "")),
                          "number of SSO matches")
        write_catalog(tcat_p, tcols, h, "trans")
        products.append(tcat_p)

        D = _host(res.D).astype(np.float32, copy=False)
        Scorr = _host(res.Scorr).astype(np.float32, copy=False)
        # PNG thumbnail grid per candidate (RED/REF/D/SCORR cutouts)
        if getattr(self.settings, "make_quicklooks", True) and len(sel):
            try:
                from blackbox_tpu_torch.report.quicklook import \
                    transient_thumbnail_grid
                png = os.path.join(rdir, base + "_trans.png")
                out = transient_thumbnail_grid(
                    png, _host(sci).astype(np.float32, copy=False),
                    _host(res.ref_remapped).astype(np.float32, copy=False),
                    D, Scorr, tc["x"][sel], tc["y"][sel],
                    size=min(int(getattr(self.settings,
                                         "size_thumbnails", 100)),
                             min(D.shape)))
                if out:
                    products.append(out)
            except Exception:
                log.exception("transient thumbnails failed for %s", base)
        del res

        d_p = os.path.join(rdir, base + "_D.fits.fz")
        sc_p = os.path.join(rdir, base + "_Scorr.fits.fz")
        self._rice(d_p, D, h, 4.0)
        self._rice(sc_p, Scorr, h, 2.0)
        products += [d_p, sc_p]
        return products
