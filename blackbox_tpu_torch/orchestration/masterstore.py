"""Master bias/dark/flat store: build, publish, and look up with fallbacks.

Rebuild of the reference's ``master_prep`` + ``get_nearest_master``
(reference blackbox.py:4625-5247, 5291-5398): if a night's master
is absent, gather the night's reduced individual cals within the
calendar window (bias ±3 d, flat ±7 d — set_blackbox.py:47), median
stack on device, QC, and publish atomically; readers fall back
current → nearest within ±1 month, skipping red-flagged masters.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re

import numpy as np

from blackbox_tpu_torch.io.fits import Header, read_fits
from blackbox_tpu_torch.io.rice import read_rice, write_rice
from blackbox_tpu_torch.io.storage import already_exists, get_backend, list_files
from blackbox_tpu_torch.orchestration.paths import DataTree


@dataclasses.dataclass(frozen=True)
class MasterPolicy:
    cal_window: dict = dataclasses.field(
        default_factory=lambda: {"bias": 3, "dark": 3, "flat": 7})
    ncal_max: dict = dataclasses.field(
        default_factory=lambda: {"bias": 20, "dark": 20, "flat": 15})
    ncal_min: int = 3
    fallback_days: int = 31
    # reject evening flats (reference blackbox.py:4776-4789: BlackGEM
    # evening flats carry a reflection; UT-fraction heuristic)
    flat_reject_eve: bool = False
    # build masters on demand (reference create_master switch); False =
    # lookup-only (the cluster's dedicated masters job builds them)
    create: bool = True


def _date_shift(date: str, days: int) -> str:
    d = datetime.date(int(date[:4]), int(date[4:6]), int(date[6:8]))
    return (d + datetime.timedelta(days=days)).strftime("%Y%m%d")


class MasterStore:
    def __init__(self, tree: DataTree, telescope: str = "ML1",
                 policy: MasterPolicy = MasterPolicy(), device="cuda"):
        self.tree = tree
        self.telescope = telescope
        self.policy = policy
        self._cache = {}
        # masters are stacked on this device (the card unless the
        # caller asks for another)
        self.device = device

    # ---- lookup ----

    def master_path(self, imgtype: str, date: str, filt=None) -> str:
        return self.tree.master_name(imgtype, date, filt)

    def find(self, imgtype: str, date: str, filt=None):
        """Nearest non-red master within ±fallback_days (blackbox.py:5291)."""
        for dd in range(self.policy.fallback_days + 1):
            for sign in ((0,) if dd == 0 else (-1, 1)):
                cand = self.master_path(imgtype, _date_shift(date, sign * dd),
                                        filt)
                ok, found = already_exists(cand, get_filename=True)
                if ok and not self._is_red(found):
                    return found
        return None

    def _is_red(self, path: str) -> bool:
        # header-only: find() probes every candidate of a ±31-day scan
        # and a full read_rice would decompress ~450 MB per probe just
        # to read one card
        h = self._read_header(path)
        if h is None:
            return True
        return str(h.get("QC-FLAG", "green")).strip() == "red"

    def load(self, imgtype: str, date: str, filt=None):
        """(data (C,ych,xch) or mosaic, header) of the best master."""
        path = self.find(imgtype, date, filt)
        if path is None:
            return None, None
        key = (path,)
        if key not in self._cache:
            data, h = read_rice(path)
            self._stamp_provenance(h, path)
            self._cache[key] = (data, h)
        return self._cache[key]

    @staticmethod
    def _stamp_provenance(h, path: str) -> None:
        """MASTERF/MDATE: which master file this is, and its night."""
        base = os.path.basename(path)
        h["MASTERF"] = (base, "master frame file")
        m = re.search(r"(\d{8})", base)
        if m:
            h["MDATE"] = (m.group(1), "master frame night (yyyymmdd)")

    # ---- building ----

    def individual_cals(self, imgtype: str, date: str, filt=None) -> list:
        """Reduced individual cal frames within the calendar window,
        vetted like the reference's master_prep input selection
        (blackbox.py:4733-4789): red-flagged frames are rejected, and —
        when the policy says so — evening flats too."""
        window = self.policy.cal_window.get(imgtype, 3)
        out = []
        for dd in range(-window, window + 1):
            d = _date_shift(date, dd)
            rdir = self.tree.red_dir(d, imgtype)
            pats = list_files(os.path.join(rdir, "*_red.fits*"))
            for p in pats:
                h = self._read_header(p)
                if h is None:
                    continue
                if filt is not None and "FILTER" in h and \
                        str(h["FILTER"]).strip() != str(filt):
                    continue
                if str(h.get("QC-FLAG", "green")).strip() == "red":
                    continue
                if imgtype == "flat" and self.policy.flat_reject_eve:
                    try:
                        frac = float(h.get("MJD-OBS")) % 1.0
                        # evening (UT frac > 0.5) or just-past-midnight
                        # summer flats (frac < 0.1)
                        if frac > 0.5 or frac < 0.1:
                            continue
                    except (TypeError, ValueError):
                        pass
                out.append((abs(dd), p, h))
        # nearest-to-midnight first, capped (blackbox.py:4852-4868)
        out.sort(key=lambda t: t[0])
        cap = self.policy.ncal_max.get(imgtype, 20)
        return [(p, h) for _, p, h in out[:cap]]

    @staticmethod
    def _read_header(path: str):
        try:
            # tile-compressed products carry the header on the bintable
            # extension; scan every HDU and merge the cards
            merged = None
            for _, h in read_fits(path):
                if merged is None:
                    merged = h
                elif len(h.keys()) > len(merged.keys()):
                    merged = h
            return merged
        except Exception:
            return None

    def _read_cached(self, path: str, header_only: bool = False):
        """(data, header) of a published master, via the pixel cache.

        ensure_master runs once per frame, and an uncached read
        decompresses a full ~450 MB mosaic each time; header_only
        callers (batched device path: the pixels are pre-staged, only
        MBIAS-F/MFLAT-F cards are needed) skip the pixels entirely
        unless they are already cached.
        """
        key = (path,)
        if key in self._cache:
            return self._cache[key]
        if header_only:
            h = self._read_header(path)
            if h is not None:
                self._stamp_provenance(h, path)
            return None, h
        data, h = read_rice(path)
        self._stamp_provenance(h, path)
        self._cache[key] = (data, h)
        return data, h

    def ensure_master(self, imgtype: str, date: str, geom, filt=None,
                      norm_sec=None, telescope=None,
                      header_only: bool = False):
        """Return (mosaic, header), building this night's master if needed.

        Masters are stored as reduced-mosaic images (like the reference's
        products); callers disassemble to channel stacks via ``geom``.
        A night whose own master grades RED is published once (for the
        audit trail) but never APPLIED: readers fall back to the
        nearest non-red master within ±fallback_days, exactly like the
        reference's get_nearest_master (blackbox.py:4797, 5291-5398);
        when no fallback exists it returns (None, None) and the master
        is not applied (see ``_fallback_or``).  An existing red master
        is NEVER rebuilt — the inputs that made it red have not changed.
        """
        tel = telescope or self.telescope
        path = self.master_path(imgtype, date, filt)
        ok, found = already_exists(path, get_filename=True)
        if ok:
            if not self._is_red(found):
                return self._read_cached(found, header_only)
            return self._fallback_or(found, imgtype, date, filt,
                                     header_only)

        files = (self.individual_cals(imgtype, date, filt)
                 if self.policy.create else [])
        if len(files) >= self.policy.ncal_min:
            # single-writer publication: the reference documents an
            # unresolved cross-job race here (blackbox.py:4741-4755);
            # an advisory lock + re-check closes it on POSIX trees
            # (GCS writes are atomic per object — no lock needed)
            from blackbox_tpu_torch.utils.locks import advisory_lock
            import contextlib
            lock = (advisory_lock(path) if "://" not in path
                    else contextlib.nullcontext())
            with lock:
                ok, found = already_exists(path, get_filename=True)
                if ok:
                    if not self._is_red(found):
                        return self._read_cached(found, header_only)
                    return self._fallback_or(found, imgtype, date,
                                             filt, header_only)
                data, header = self._build(imgtype, files, filt, tel,
                                           geom, norm_sec)
                write_rice(path, np.asarray(data, np.float32), header,
                           qlevel=32.0)
            self._stamp_provenance(header, path)
            if str(header.get("QC-FLAG", "green")).strip() == "red":
                return self._fallback_or(path, imgtype, date, filt,
                                         header_only)
            self._cache[(path,)] = (data, header)
            return data, header
        # fallback: nearest older master (header_only threads through —
        # the batched device path only needs the MBIAS-F/MFLAT-F cards,
        # not a ~450 MB decompress)
        path = self.find(imgtype, date, filt)
        if path is None:
            return None, None
        return self._read_cached(path, header_only)

    def _fallback_or(self, red_path: str, imgtype: str, date: str,
                     filt, header_only: bool):
        """Nearest non-red master, else (None, None).

        The reference's get_nearest_master (blackbox.py:5291-5398)
        returns None when every candidate is red-flagged — the master
        is simply not applied and the frame keeps MBIAS-P/MFLAT-P =
        False.  Returning the red master here instead would stamp the
        frame as corrected with no indication a red-flagged calibration
        product was used (only the master's own header carries the
        flag, and only MASTERF/MDATE propagate).
        """
        del red_path  # kept in the signature for the call sites' clarity
        alt = self.find(imgtype, date, filt)
        if alt is not None:
            return self._read_cached(alt, header_only)
        return None, None

    def _build(self, imgtype: str, files: list, filt, tel, geom, norm_sec):
        import torch
        from blackbox_tpu_torch.pipeline import masters as M
        from blackbox_tpu_torch.utils.timing import count

        frames, headers = [], []
        for f, h0 in files:
            img, _ = read_rice(f)
            frames.append(geom.disassemble(torch.as_tensor(
                np.asarray(img, np.float32), device=self.device)))
            headers.append(h0)

        h = Header()
        h["IMAGETYP"] = (f"m{imgtype}", "master frame type")
        h["NUSED"] = (len(files), "number of frames combined")
        for i, (f, _) in enumerate(files[:20]):
            h[f"ORIG{i + 1:02d}"] = (os.path.basename(f), "input frame")
        if filt is not None:
            h["FILTER"] = (str(filt), "filter")

        exptimes = None
        if imgtype == "dark":
            # exposure-time-normalised dark current [e-/s]
            # (reference master dark, blackbox.py:1720-1743)
            exptimes = torch.tensor(
                [max(float(h0.get("EXPTIME", 1.0) or 1.0), 1e-6)
                 for h0 in headers], dtype=torch.float32,
                device=self.device)
        # the frames list is emptied once stacked (build_master)
        master, stats = M.build_master(imgtype, frames, geom, norm_sec,
                                       exptimes)
        if imgtype == "flat":
            self._stamp_dither(h, headers)
        from blackbox_tpu_torch.pipeline.headers import stamp_master
        # stamp_master reads every statistic but the frame count, which
        # is made on the host
        count("host.reads", len(stats) - 1)
        stamp_master(h, imgtype, {k: v.cpu().numpy()
                                  for k, v in stats.items()})
        from blackbox_tpu_torch.qc.engine import run_qc_check
        run_qc_check(h, tel, check_key_type=f"m{imgtype}")
        count("host.reads")
        return geom.assemble(master).cpu().numpy(), h

    @staticmethod
    def _stamp_dither(h, headers) -> None:
        """Flat dithering check (reference blackbox.py:5027-5055):
        consecutive pointing offsets >= 5 arcsec; FLATDITH requires a
        2/3 majority."""
        from blackbox_tpu_torch.astro.wcs import haversine
        # chronological order: the selection list is sorted by window
        # DISTANCE (for the ncal_max cap), which interleaves nights —
        # "consecutive" offsets must compare frames taken back to back,
        # as the reference sorts by mjd_obs before its dither check
        # (blackbox.py:5027-5055)
        def _mjd(h0):
            try:
                return float(h0.get("MJD-OBS"))
            except (TypeError, ValueError):
                return 0.0
        ra, dec = [], []
        for h0 in sorted(headers, key=_mjd):
            try:
                ra.append(float(h0.get("RA")))
                dec.append(float(h0.get("DEC")))
            except (TypeError, ValueError):
                pass
        noffset, off_mean = 0, 0.0
        if len(ra) > 1:
            ra_a, dec_a = np.asarray(ra), np.asarray(dec)
            off = 3600.0 * haversine(ra_a, dec_a, np.roll(ra_a, 1),
                                     np.roll(dec_a, 1))
            mask = off >= 5.0
            noffset = int(np.sum(mask))
            if noffset:
                off_mean = float(np.mean(off[mask]))
        h["N-OFFSET"] = (noffset, "number of flats offset > 5 arcsec")
        h["OFF-MEAN"] = (round(off_mean, 2), "[arcsec] mean dither offset")
        h["FLATDITH"] = (bool(len(headers) and
                              noffset / len(headers) >= 0.66),
                         "majority of flats were dithered")
