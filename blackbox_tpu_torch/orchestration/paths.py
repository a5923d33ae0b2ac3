"""Directory and filename conventions of the survey data tree.

Rebuild of the reference's path layer (reference Settings/
set_blackbox.py:89-153 directory trees; blackbox.py:1004-1022
get_filename_red; 7573-7648 sort_files): per-telescope trees

    <root>/<tel>/raw/yyyy/mm/dd/            incoming frames
    <root>/<tel>/red/yyyy/mm/dd/{bias,dark,flat,}   products
    <root>/<tel>/masters/                   master bias/dark/flat
    <root>/<tel>/ref/<fieldID>/             reference co-adds
    <root>/<tel>/tmp/<base>/                per-image scratch
    <root>/<tel>/headers/                   header-table index

and filenames ``<tel>_yyyymmdd_hhmmss`` with product suffixes
``_red.fits.fz  _mask.fits.fz  _red_hdr.fits  _red_cat.fits
_red_trans.fits  .log``.
"""

from __future__ import annotations

import dataclasses
import os
import re


PRODUCT_EXTS = {
    # reference keep-lists (set_blackbox.py:157-166)
    "img_reduce": ["_red.fits.fz", "_mask.fits.fz", "_red_hdr.fits",
                   "_red.log"],
    "cat_extract": ["_red_cat.fits"],
    "trans_extract": ["_red_trans.fits", "_D.fits.fz", "_Scorr.fits.fz",
                      "_trans_limmag.fits.fz", "_red_trans_hdr.fits"],
}

IMGTYPES = ("bias", "dark", "flat", "object")


@dataclasses.dataclass(frozen=True)
class DataTree:
    root: str
    telescope: str

    def _t(self, *parts) -> str:
        return os.path.join(self.root, self.telescope, *parts)

    def raw_dir(self, date: str) -> str:
        y, m, d = date[:4], date[4:6], date[6:8]
        return self._t("raw", y, m, d)

    def red_dir(self, date: str, imgtype: str = "object") -> str:
        y, m, d = date[:4], date[4:6], date[6:8]
        sub = () if imgtype == "object" else (imgtype,)
        return self._t("red", y, m, d, *sub)

    def log_dir(self) -> str:
        return self._t("log")

    def master_dir(self) -> str:
        return self._t("masters")

    def ref_dir(self, field_id: int) -> str:
        return self._t("ref", f"{field_id:05d}")

    def tmp_dir(self, base: str) -> str:
        return self._t("tmp", base)

    def headers_dir(self) -> str:
        return self._t("headers")

    def master_name(self, imgtype: str, date: str,
                    filt: str | None = None) -> str:
        if imgtype == "flat":
            return os.path.join(self.master_dir(),
                                f"{imgtype}_{date}_{filt}.fits.fz")
        return os.path.join(self.master_dir(),
                            f"{imgtype}_{date}.fits.fz")


_FNAME_RE = re.compile(
    r"(?P<tel>[A-Za-z0-9]+)[._-](?P<date>\d{8})[._-](?P<time>\d{6})")


def parse_raw_name(filename: str):
    """telescope/date/time from a raw frame name; None if nonstandard."""
    m = _FNAME_RE.search(os.path.basename(filename))
    if not m:
        return None
    return m.group("tel"), m.group("date"), m.group("time")


def base_name(filename: str) -> str:
    """Image basename without directories or .fits(.fz|.gz) suffixes."""
    b = os.path.basename(filename)
    for suf in (".fits.fz", ".fits.gz", ".fits"):
        if b.endswith(suf):
            return b[:-len(suf)]
    return b


def red_products(tree: DataTree, date: str, base: str,
                 tasks=("img_reduce",), imgtype: str = "object") -> list:
    """Expected product paths in the red tree for the given tasks."""
    d = tree.red_dir(date, imgtype)
    if imgtype != "object":
        return [os.path.join(d, base + "_red.fits.fz")]
    out = []
    for t in tasks:
        out += [os.path.join(d, base + ext) for ext in PRODUCT_EXTS[t]]
    return out


def night_date(header_or_mjd, site_longitude_deg: float = 20.81) -> str:
    """Observing-night yyyymmdd: the local evening date of the frame.

    The reference derives night boundaries from the evening date
    (blackbox_slurm_google.py:140-157): shift UTC by the site longitude
    and subtract 12 h so a whole night shares one date.
    """
    import datetime
    if isinstance(header_or_mjd, (int, float)):
        mjd = float(header_or_mjd)
    else:
        from blackbox_tpu_torch.astro.time import iso2mjd
        mjd = iso2mjd(str(header_or_mjd))
    dt = datetime.datetime(1858, 11, 17, tzinfo=datetime.timezone.utc)\
        + datetime.timedelta(days=mjd)
    local = dt + datetime.timedelta(hours=site_longitude_deg / 15.0)
    evening = local - datetime.timedelta(hours=12)
    return evening.strftime("%Y%m%d")
