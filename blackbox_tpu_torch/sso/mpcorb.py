"""MPCORB orbit-catalog ingestion.

The reference's known-object annotation runs the external match2SSO
package against the Minor Planet Center's full MPCORB catalog
(reference blackbox.py:3258-3275).  This module parses the
documented MPCORB.DAT fixed-column export format (one 202-char line per
object; column layout from the MPC's "Export Format for Minor-Planet
Orbits") into :class:`blackbox_tpu_torch.sso.match.Elements`.

Column layout (1-indexed, inclusive):

    1-7    packed designation          9-13   H        15-19  G
    21-25  packed epoch (TT)           27-35  M [deg]  38-46  argper
    48-56  node [deg]                  59-67  incl     71-79  e
    81-91  mean motion [deg/day]       93-103 a [au]

Packed epoch: century letter (I=18, J=19, K=20), 2-digit year, then
month and day in the MPC base-31 digit set 1-9, A-V.
"""

from __future__ import annotations

import gzip
from typing import Iterable, Optional

from blackbox_tpu_torch.sso.match import Elements

_CENTURY = {"I": 1800, "J": 1900, "K": 2000, "L": 2100}
_B31 = "123456789ABCDEFGHIJKLMNOPQRSTUV"
_B62 = ("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz")


def _b31(ch: str) -> int:
    i = _B31.find(ch)
    if i < 0:
        raise ValueError(f"bad packed base-31 digit {ch!r}")
    return i + 1


def unpack_epoch(packed: str) -> float:
    """Packed MPC epoch (e.g. 'K239D') -> MJD (TT, 00:00).

    The day count here follows the proleptic Gregorian calendar through
    the ``datetime`` module, matching MPC epochs (all modern).
    """
    import datetime
    packed = packed.strip()
    year = _CENTURY[packed[0]] + int(packed[1:3])
    month = _b31(packed[3])
    day = _b31(packed[4])
    d = datetime.date(year, month, day)
    return (d - datetime.date(1858, 11, 17)).days + 0.0


def unpack_designation(packed: str) -> str:
    """Human-readable designation from the 7-char packed form.

    Numbered: '00001' -> '1'; base-62 first char extends past 99999
    ('A0001' -> '100001'); '~' prefix = base-62 extended numbering.
    Provisional: 'K23A00B' -> '2023 AB0'-style unpacking.
    """
    p = packed.strip()
    if not p:
        return p
    if p[0] == "~":                      # extended numbered, base 62
        n = 0
        for ch in p[1:]:
            n = n * 62 + _B62.index(ch)
        return str(n + 620000)
    if len(p) == 5 and p[1:].isdigit():
        if p[0].isdigit():               # plain numbered
            return str(int(p))
        return str(_B62.index(p[0]) * 10000 + int(p[1:]))
    if len(p) == 7 and p[0] in _CENTURY:  # provisional designation
        year = _CENTURY[p[0]] + int(p[1:3])
        half = p[3]
        order = p[6]
        cycle = _B62.index(p[4]) * 10 + int(p[5]) if not p[4].isdigit() \
            else int(p[4:6])
        suffix = str(cycle) if cycle else ""
        return f"{year} {half}{order}{suffix}"
    return p


def parse_line(line: str) -> Optional[Elements]:
    """One MPCORB data line -> Elements (None for blank/invalid rows)."""
    if len(line) < 103 or not line.strip():
        return None
    try:
        desig = unpack_designation(line[0:7])
        h_s = line[8:13].strip()
        g_s = line[14:19].strip()
        epoch = unpack_epoch(line[20:25])
        M0 = float(line[26:35])
        argper = float(line[37:46])
        node = float(line[47:56])
        incl = float(line[58:67])
        e = float(line[70:79])
        a = float(line[92:103])
    except (ValueError, KeyError, IndexError):
        return None
    return Elements(
        designation=desig, a=a, e=e, incl=incl, node=node,
        argper=argper, M0=M0, epoch_mjd=epoch,
        H=float(h_s) if h_s else 20.0,
        G=float(g_s) if g_s else 0.15)


def parse_mpcorb(path_or_lines, max_objects: Optional[int] = None,
                 h_max: Optional[float] = None) -> list:
    """Parse an MPCORB file (plain or .gz) or an iterable of lines.

    The real file opens with a free-text header terminated by a
    ``----`` ruler line; everything after it is data.  ``h_max`` keeps
    only objects at least that bright (absolute magnitude) — the usual
    way to bound the nightly catalog like match2SSO's selections.
    """
    if isinstance(path_or_lines, str):
        op = gzip.open if path_or_lines.endswith(".gz") else open
        with op(path_or_lines, "rt") as f:
            return parse_mpcorb(list(f), max_objects, h_max)
    lines: Iterable[str] = path_or_lines
    out = []
    in_header = False
    for i, line in enumerate(lines):
        if i == 0 and not parse_line(line):
            in_header = True
        if in_header:
            if line.startswith("----"):
                in_header = False
            continue
        el = parse_line(line)
        if el is None:
            continue
        if h_max is not None and el.H > h_max:
            continue
        out.append(el)
        if max_objects and len(out) >= max_objects:
            break
    return out
