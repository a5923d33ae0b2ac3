"""Header-table index: the queryable per-telescope product database.

Rebuild of the reference's ``add_headkeys`` (reference blackbox.py:
7965-8083): every reduced frame's header keys are appended to big
per-telescope FITS tables (<tel>_headers_{cat,trans,bias,flat}.fits),
unique by FILENAME keep-last.  buildref reads these tables as its input
index (buildref.py:160-221); the obslog and monitoring query them too.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from blackbox_tpu_torch.io.fits import Header, read_fits, write_image
from blackbox_tpu_torch.io.storage import get_backend
from blackbox_tpu_torch.orchestration.paths import DataTree

# key sets per table kind (reference get_head_row, blackbox.py:8059-8083)
TABLE_KEYS = {
    "cat": ["FILENAME", "MJD-OBS", "DATE-OBS", "OBJECT", "FILTER",
            "EXPTIME", "RA", "DEC", "AIRMASS", "S-SEEING", "S-BKG",
            "RDNOISE", "NOBJECTS", "PC-ZP", "PC-ZPSTD", "LIMMAG",
            "QC-FLAG", "ISTRACKI"],
    "trans": ["FILENAME", "MJD-OBS", "OBJECT", "FILTER", "T-NTRANS",
              "T-NPOS", "T-NNEG", "Z-FRATIO", "Z-SCSTD", "TQC-FLAG"],
    "sso": ["FILENAME", "MJD-OBS", "OBJECT", "FILTER", "N-SSO",
            "TQC-FLAG"],
    "bias": ["FILENAME", "MJD-OBS", "DATE-OBS", "RDNOISE", "BIASMEAN",
             "QC-FLAG"],
    "flat": ["FILENAME", "MJD-OBS", "DATE-OBS", "FILTER", "MEDSEC",
             "RSTDSEC", "QC-FLAG"],
}

_STR_WIDTH = 48


def table_path(tree: DataTree, telescope: str, kind: str) -> str:
    return os.path.join(tree.headers_dir(),
                        f"{telescope}_headers_{kind}.fits")


def _row_from_header(h, filename: str, kind: str) -> dict:
    row = {"FILENAME": os.path.basename(filename)[:_STR_WIDTH]}
    for k in TABLE_KEYS[kind][1:]:
        row[k] = h.get(k)
    return row


def read_table(tree: DataTree, telescope: str, kind: str) -> dict:
    p = table_path(tree, telescope, kind)
    be = get_backend(p)
    if not be.isfile(p):
        return {k: [] for k in TABLE_KEYS[kind]}
    for data, h in read_fits(p):
        if isinstance(data, dict):
            out = {}
            for k, v in data.items():
                vals = list(v)
                if vals and isinstance(vals[0], (str, np.str_)):
                    vals = [str(x).strip() for x in vals]
                out[k] = vals
            return out
    return {k: [] for k in TABLE_KEYS[kind]}


def _coerce_column(name: str, values: list):
    if name in ("FILENAME", "DATE-OBS", "OBJECT", "FILTER", "QC-FLAG",
                "TQC-FLAG"):
        return np.array([(str(v) if v is not None else "-")[:_STR_WIDTH]
                         for v in values], f"U{_STR_WIDTH}")
    if name == "ISTRACKI":
        return np.array([bool(v) if v is not None else False
                         for v in values], bool)
    out = np.full(len(values), np.nan, np.float64)
    for i, v in enumerate(values):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def add_headkeys(tree: DataTree, telescope: str, kind: str,
                 headers: Iterable, filenames: Iterable[str]) -> str:
    """Append rows (unique by FILENAME, keep-last) and rewrite the table."""
    table = read_table(tree, telescope, kind)
    keys = TABLE_KEYS[kind]
    rows = {str(f): i for i, f in enumerate(table["FILENAME"])}

    for h, f in zip(headers, filenames):
        row = _row_from_header(h, f, kind)
        name = row["FILENAME"]
        if name in rows:
            i = rows[name]
            for k in keys:
                table[k][i] = row.get(k)
        else:
            rows[name] = len(table["FILENAME"])
            for k in keys:
                table[k].append(row.get(k))

    cols = {k: _coerce_column(k, table[k]) for k in keys}
    p = table_path(tree, telescope, kind)
    get_backend(p).make_dir(os.path.dirname(p))
    hh = Header()
    hh["TABKIND"] = (kind, "header-table kind")
    write_image(p, None, Header(), extensions=[("table", cols, hh)])
    return p


def add_night_headkeys(root: str, telescope: str, kind: str,
                       date: str) -> str:
    """Scan one night's reduced products and append their header keys
    to the big per-telescope table (the end-of-night add_headkeys jobs,
    reference blackbox_slurm_ilifu.py:338-362)."""
    import glob

    from blackbox_tpu_torch.io.fits import read_fits

    tree = DataTree(root, telescope)
    patterns = {
        "cat": [("", "*_red_hdr.fits")],
        "trans": [("", "*_red_trans.fits")],
        "sso": [("", "*_red_trans.fits")],
        "bias": [("bias", "*_red.fits*")],
        "flat": [("flat", "*_red.fits*")],
    }[kind]
    headers, names = [], []
    for sub, pat in patterns:
        rdir = tree.red_dir(date, sub or "object")
        for p in sorted(glob.glob(os.path.join(rdir, pat))):
            try:
                merged = None
                for _, h in read_fits(p):
                    if merged is None or len(h.keys()) > len(merged.keys()):
                        merged = h
                if merged is None:
                    continue
                if kind == "sso" and "N-SSO" not in merged:
                    continue
                headers.append(merged)
                names.append(os.path.basename(p).replace(
                    "_red_hdr.fits", "_red.fits").replace(
                    "_red_trans.fits", "_red.fits").replace(
                    ".fits.fz", ".fits"))
            except Exception:
                continue
    if headers:
        add_headkeys(tree, telescope, kind, headers, names)
    return table_path(tree, telescope, kind)


def query(tree: DataTree, telescope: str, kind: str, **cuts) -> list:
    """Row dicts passing simple equality/range cuts.

    cuts: KEY=value (equality), KEY=(lo, hi) (inclusive range),
    KEY=callable (predicate).
    """
    t = read_table(tree, telescope, kind)
    n = len(t["FILENAME"])
    out = []
    for i in range(n):
        row = {k: t[k][i] for k in t}
        ok = True
        for k, c in cuts.items():
            v = row.get(k)
            if callable(c):
                ok = c(v)
            elif isinstance(c, tuple) and len(c) == 2:
                try:
                    ok = c[0] <= float(v) <= c[1]
                except (TypeError, ValueError):
                    ok = False
            else:
                ok = (str(v).strip() == str(c).strip())
            if not ok:
                break
        if ok:
            out.append(row)
    return out
