"""Declarative header quality control.

Rebuild of the reference QC layer (reference qc.py:15-551 with the
range table in Settings/set_qc.py): every product header is range-checked
against a declarative table and given a graded green/yellow/orange/red
flag; red products short-circuit into zero-row dummy catalogs so the
downstream schema never breaks.

Range entry semantics (matching the reference contract):

``val_type``
  - ``min_max``:  ranges [(lo, hi), ...] graded green/yellow/orange
  - ``bool``:     ranges [ok_value]
  - ``sigma``:    (expected, std) expanded with n_std = [2, 4, 7]
  - ``exp_abs``:  [(expected, tol), ...] — |value - expected| <= tol
  - ``exp_frac``: [(expected, frac), ...] — |(value-E)/E| <= frac
  - ``key``:      min_max whose bounds may be expression strings
                  evaluated against the header (reference set_qc.py
                  PC-MZPD: ``0.00 + 5*header['PC-ZPSTD']``)
  - ``skip``:     tracked for dummy-catalog defaults only

``val_range`` may be a dict keyed by filter.  ``key_type`` groups keywords
by product ('full', 'trans', 'flat', 'mbias', 'mflat', 'bias', 'ref',
'raw').  ``default`` supplies the value used when building dummy products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from blackbox_tpu_torch.config.base import get_par

COLORS = ["green", "yellow", "orange", "red"]
N_STD = [2, 4, 7]


@dataclasses.dataclass
class QCResult:
    color: str                      # overall flag
    keys: list                      # non-green keywords
    colors: list                    # their flags
    ranges: list                    # the range that would have been green
    comments: list

    @property
    def is_red(self):
        return self.color == "red"


# keywords whose sigma windows double near the celestial pole
# (reference qc.py:278-281: unexplained astrometric scatter increase)
POLE_RELAX_KEYS = ("A-DRA", "A-DRASTD", "A-DDEC", "A-DDESTD")


class _SkipCheck(Exception):
    """Raised when a range cannot be resolved and the reference would
    skip (not fail) the keyword — e.g. un-evaluable 'key' expressions."""


def _expand_ranges(entry, filt, header=None, key=None):
    vr = entry["val_range"]
    if isinstance(vr, dict):
        # the reference indexes by filter directly and fails loudly on an
        # unknown one (set_qc per-filter dicts); silently grading against
        # an arbitrary filter's range could green-flag bad data, so an
        # unknown/missing filter KeyErrors here and the keyword goes red
        vr = vr[filt]
    vt = entry["val_type"]
    if vt == "sigma":
        exp, std = vr[0] if isinstance(vr[0], (tuple, list)) else vr
        ranges, vt = [(exp, n * std) for n in N_STD], "exp_abs"
        # pole relaxation: double (expected, tolerance) for the
        # astrometric keywords on object frames near the pole
        # (qc.py:278-281 — `2 * np.array` after sigma expansion)
        if (key in POLE_RELAX_KEYS and header is not None
                and str(header.get("IMAGETYP", "")).lower() == "object"):
            try:
                if float(header.get("DEC")) <= -87.0:
                    ranges = [(2 * e, 2 * t) for e, t in ranges]
            except (TypeError, ValueError):
                pass
        return ranges, vt
    if vt == "key":
        # entries may hold expression strings referencing other header
        # values (e.g. PC-MZPD <= 0.00 + 5*PC-ZPSTD, set_qc.py:334);
        # un-evaluable expressions skip the check like the reference
        out = []
        for r in vr:
            vals = []
            for v in r:
                if isinstance(v, str):
                    try:
                        v = eval(v, {"header": header})  # noqa: S307
                    except Exception:
                        raise _SkipCheck(key)
                vals.append(v)
            out.append(tuple(vals))
        return out, "min_max"
    return list(vr), vt


def _report_range(entry, r, vt):
    """The (lo, hi) window to REPORT for a graded keyword.  For
    'pos'-marked keywords the reference floors only this reported
    range_ok at 0 (qc.py:324-329) — the pass/fail test itself stays the
    raw exp_abs/exp_frac/min_max check, so a slightly negative value of
    a pos keyword still greens if the raw window admits it."""
    if r is None or vt == "bool":
        return r
    if vt == "min_max":
        lo, hi = r
    elif vt == "exp_abs":
        lo, hi = r[0] - r[1], r[0] + r[1]
    elif vt == "exp_frac":
        lo, hi = r[0] * (1 - r[1]), r[0] * (1 + r[1])
        if lo > hi:          # negative expectation inverts the window
            lo, hi = hi, lo
    else:
        return r
    if entry.get("pos"):
        lo, hi = max(0, lo), max(0, hi)
    return (lo, hi)


def _grade(value, ranges, vt, header) -> int:
    """Return color index 0..3 for a value against expanded ranges."""
    if vt == "bool" and isinstance(value, str):
        # BGreduce legacy: boolean keywords arriving as 'T' strings
        value = value.strip() == "T"
    for i, r in enumerate(ranges[:3]):
        if vt == "bool":
            ok = bool(value) == bool(r)
        elif vt == "min_max":
            ok = r[0] <= value <= r[1]
        elif vt == "exp_abs":
            ok = abs(value - r[0]) <= r[1]
        elif vt == "exp_frac":
            exp = r[0]
            ok = abs((value - exp) / exp) <= r[1] if exp != 0 else False
        else:
            return 0
        if ok:
            return i
    return 3


def qc_check(header, ranges_table, telescope: str = "ML1",
             keywords=None, check_key_type: Optional[str] = None,
             hide_greens: bool = True) -> QCResult:
    """Check header keywords against the QC range table."""
    table = get_par(ranges_table, telescope)
    filt = header.get("FILTER") if hasattr(header, "get") else None

    out_keys, out_colors, out_ranges, out_comments = [], [], [], []
    worst = 0
    keys = keywords if keywords is not None else list(table.keys())
    for key in keys:
        entry = table.get(key)
        if entry is None or entry["val_type"] == "skip":
            continue
        if check_key_type and entry.get("key_type") != check_key_type:
            continue
        if key not in header:
            continue
        # tracking is only required of on-sky object frames
        # (reference qc.py:196-199)
        if key == "ISTRACKI" and \
                str(header.get("IMAGETYP", "object")).lower() != "object":
            continue
        value = header[key]
        if value is None or (isinstance(value, str) and
                             value in ("None", "NaN")):
            ci = 3
            ranges, vt = [], entry["val_type"]
        else:
            try:
                ranges, vt = _expand_ranges(entry, filt, header, key)
                ci = _grade(value, ranges, vt, header)
            except _SkipCheck:
                continue
            except Exception:
                ci = 3
                ranges = []
        worst = max(worst, ci)
        if ci > 0 or not hide_greens:
            out_keys.append(key)
            out_colors.append(COLORS[ci])
            out_ranges.append(_report_range(
                entry, ranges[min(ci, len(ranges) - 1)] if ranges else None,
                vt if ranges else entry["val_type"]))
            out_comments.append(entry.get("comment", ""))
    return QCResult(COLORS[worst], out_keys, out_colors, out_ranges,
                    out_comments)


def run_qc_check(header, telescope: str = "ML1",
                 check_key_type: Optional[str] = None,
                 ranges_table=None, flag_key: str = "QC-FLAG") -> str:
    """Grade a header, stamp QC-FLAG + per-color culprit keys, return color.

    Reference contract (qc.py:399-449): QC-FLAG (or TQC-FLAG for the
    transient catalog) plus QCRED1../QCORA1../QCYEL1.. keywords naming the
    offending keywords.
    """
    if ranges_table is None:
        from blackbox_tpu_torch.qc.ranges import QC_RANGES
        ranges_table = QC_RANGES
    res = qc_check(header, ranges_table, telescope,
                   check_key_type=check_key_type)
    prefix = "T" if flag_key.startswith("T") else ""
    counters = {"red": 0, "orange": 0, "yellow": 0}
    for key, color in zip(res.keys, res.colors):
        if color in counters:
            counters[color] += 1
            tag = {"red": "RED", "orange": "ORA", "yellow": "YEL"}[color]
            header[f"{prefix}QC{tag}{counters[color]}"] = (
                key, f"{color}-flagged keyword")
    header[flag_key] = (res.color, "QC flag color (green|yellow|orange|red)")
    return res.color
