"""Minimal, dependency-free FITS I/O (images + binary tables).

The reference reads/writes everything through astropy/fitsio
(`read_hdulist`/`write_fits`, reference blackbox.py:7478-8110); this
image has neither, so the framework owns its FITS layer: 2880-byte blocks,
80-char cards, image HDUs (BITPIX 8/16/32/-32/-64 with BZERO/BSCALE), and
BINTABLE extensions for catalogs.  Rice tile compression (fpack parity)
lives in :mod:`blackbox_tpu_torch.io.rice` on top of this.

Headers are :class:`Header` objects — ordered key -> (value, comment) maps
that preserve card order, since the FITS header is the pipeline's metrics
store (SURVEY.md §5.5).
"""

from __future__ import annotations

import contextlib
import gzip
from typing import Any, Iterable, Optional

import numpy as np

BLOCK = 2880
CARD = 80


@contextlib.contextmanager
def open_path(path: str, mode: str):
    """Open a POSIX or gs:// path, transparently (de)compressing .gz.

    Routes through :func:`blackbox_tpu_torch.io.storage.get_backend` so every
    FITS product reads/writes identically on the local filesystem and
    on a bucket (the reference branches on the gs:// prefix in each
    helper, blackbox.py:7664-7766)."""
    from blackbox_tpu_torch.io.storage import get_backend
    fh = get_backend(path).open(path, mode)
    try:
        if str(path).endswith(".gz"):
            gz = gzip.GzipFile(fileobj=fh,
                               mode="rb" if "r" in mode else "wb")
            try:
                yield gz
            finally:
                gz.close()
        else:
            yield fh
    finally:
        fh.close()

_BITPIX = {
    np.dtype(">u1"): 8, np.dtype(">i2"): 16, np.dtype(">i4"): 32,
    np.dtype(">i8"): 64, np.dtype(">f4"): -32, np.dtype(">f8"): -64,
}
_DTYPES = {v: k for k, v in _BITPIX.items()}


class Header:
    """Ordered FITS header: key -> value with optional comment."""

    def __init__(self, items: Optional[Iterable] = None):
        self._keys: list[str] = []
        self._vals: dict[str, Any] = {}
        self._comments: dict[str, str] = {}
        if items:
            if isinstance(items, dict):
                items = items.items()
            for k, v in items:
                if isinstance(v, tuple) and len(v) == 2:
                    self.set(k, v[0], v[1])
                else:
                    self.set(k, v)

    def set(self, key: str, value: Any, comment: str = ""):
        key = key.upper()
        if key not in self._vals:
            self._keys.append(key)
        self._vals[key] = value
        if comment:
            self._comments[key] = comment

    def __setitem__(self, key, value):
        if isinstance(value, tuple) and len(value) == 2:
            self.set(key, value[0], value[1])
        else:
            self.set(key, value)

    def __getitem__(self, key):
        return self._vals[key.upper()]

    def get(self, key, default=None):
        return self._vals.get(key.upper(), default)

    def __contains__(self, key):
        return key.upper() in self._vals

    def __delitem__(self, key):
        key = key.upper()
        self._keys.remove(key)
        self._vals.pop(key)
        self._comments.pop(key, None)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self._vals[k]) for k in self._keys]

    def comment(self, key):
        return self._comments.get(key.upper(), "")

    def copy(self):
        h = Header()
        for k in self._keys:
            h.set(k, self._vals[k], self._comments.get(k, ""))
        return h

    def update(self, other):
        for k in other.keys() if hasattr(other, "keys") else other:
            if isinstance(other, Header):
                self.set(k, other[k], other.comment(k))
            else:
                self[k] = other[k]

    def to_dict(self):
        return dict(self._vals)


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        if not np.isfinite(v):
            return "'NaN'" if np.isnan(v) else f"'{v}'"
        s = repr(float(v))
        return s
    if v is None:
        return "'None'"
    s = str(v).replace("'", "''")
    return "'" + s.ljust(8) + "'"


def _card(key: str, value, comment: str = "") -> bytes:
    if key in ("COMMENT", "HISTORY", ""):
        return (key.ljust(8) + str(value))[:CARD].ljust(CARD).encode()
    vs = _fmt_value(value)
    if len(vs) < 20 and not vs.startswith("'"):
        vs = vs.rjust(20)
    card = f"{key.ljust(8)}= {vs}"
    if comment:
        card += " / " + comment
    return card[:CARD].ljust(CARD).encode()


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        # string: up to closing quote ('' escapes)
        out, i = [], 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if "/" in raw:
        raw = raw.split("/", 1)[0].strip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _parse_comment(raw: str) -> str:
    if raw.strip().startswith("'"):
        i = raw.find("'", raw.find("'") + 1)
        rest = raw[i + 1:] if i >= 0 else ""
    else:
        rest = raw
    if "/" in rest:
        return rest.split("/", 1)[1].strip()
    return ""


def _read_header(fh) -> Header:
    h = Header()
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            raise EOFError("truncated FITS header")
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                return h
            if not key or key in ("COMMENT", "HISTORY"):
                if card[8:].strip():
                    h.set(key or "COMMENT", card[8:].strip())
                continue
            if card[8:10] != "= ":
                continue
            h.set(key, _parse_value(card[10:]), _parse_comment(card[10:]))


def _pad(n: int) -> int:
    return (-n) % BLOCK


def _header_bytes(h: Header, cards_first: list[bytes]) -> bytes:
    out = b"".join(cards_first)
    for k in h.keys():
        if k in ("SIMPLE", "BITPIX", "XTENSION", "NAXIS", "NAXIS1",
                 "NAXIS2", "PCOUNT", "GCOUNT", "TFIELDS", "BZERO",
                 "BSCALE", "EXTEND", "END") or k.startswith(("TTYPE",
                                                             "TFORM")):
            continue
        out += _card(k, h[k], h.comment(k))
    out += b"END".ljust(CARD)
    return out + b" " * _pad(len(out))


def write_image(path: str, data: Optional[np.ndarray],
                header: Optional[Header] = None, extensions=()):
    """Write a FITS file: primary image HDU + optional extensions.

    extensions: sequence of ("image", data, header) or
    ("table", dict_of_columns, header) tuples.
    """
    header = header or Header()
    with open_path(path, "wb") as fh:
        _write_image_hdu(fh, data, header, primary=True,
                         extend=bool(extensions))
        for ext in extensions:
            kind = ext[0]
            if kind == "image":
                _write_image_hdu(fh, ext[1], ext[2] or Header(),
                                 primary=False)
            elif kind == "table":
                _write_table_hdu(fh, ext[1], ext[2] or Header())
            else:
                raise ValueError(f"unknown extension kind {kind}")


def _write_image_hdu(fh, data, header, primary=True, extend=False):
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_card("XTENSION", "IMAGE", "image extension"))

    bzero = 0.0
    if data is None:
        cards.append(_card("BITPIX", 8))
        cards.append(_card("NAXIS", 0))
    else:
        d = np.asarray(data)
        if d.dtype == np.uint8:
            be = d.astype(">u1")
        elif d.dtype == np.uint16:
            be = (d.astype(np.int32) - 32768).astype(">i2")
            bzero = 32768.0
        elif d.dtype in (np.float64,):
            be = d.astype(">f8")
        elif d.dtype in (np.int16,):
            be = d.astype(">i2")
        elif d.dtype in (np.int32,):
            be = d.astype(">i4")
        elif d.dtype in (np.int64,):
            be = d.astype(">i8")
        else:
            be = d.astype(">f4")
        bitpix = {"u1": 8, "i2": 16, "i4": 32, "i8": 64,
                  "f4": -32, "f8": -64}[be.dtype.str[1:]]
        cards.append(_card("BITPIX", bitpix))
        cards.append(_card("NAXIS", d.ndim))
        for i, n in enumerate(reversed(d.shape)):
            cards.append(_card(f"NAXIS{i + 1}", n))
    if not primary:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    elif extend:
        cards.append(_card("EXTEND", True))
    if bzero:
        cards.append(_card("BZERO", bzero))
        cards.append(_card("BSCALE", 1.0))

    fh.write(_header_bytes(header, cards))
    if data is not None:
        raw = be.tobytes()
        fh.write(raw)
        fh.write(b"\x00" * _pad(len(raw)))


_TFORM = {
    np.dtype(np.float32): "E", np.dtype(np.float64): "D",
    np.dtype(np.int16): "I", np.dtype(np.int32): "J",
    np.dtype(np.int64): "K", np.dtype(np.uint8): "B",
    np.dtype(np.bool_): "L",
}


def _write_table_hdu(fh, columns: dict, header: Header):
    """Binary table HDU.  A column given as a *list of bytes/uint8
    arrays* becomes a variable-length '1PB(max)' column with a heap
    (the CFITSIO tile-compression convention needs this)."""
    names = list(columns.keys())
    arrs = []
    tforms = []
    var_cols = {}
    for n in names:
        if isinstance(columns[n], list) and columns[n] and \
                isinstance(columns[n][0], (bytes, bytearray, np.ndarray)) \
                and (isinstance(columns[n][0], (bytes, bytearray))
                     or np.asarray(columns[n][0]).dtype == np.uint8):
            rows = [np.frombuffer(bytes(r), np.uint8) if
                    isinstance(r, (bytes, bytearray)) else
                    np.asarray(r, np.uint8) for r in columns[n]]
            var_cols[n] = rows
            arrs.append(None)
            tforms.append(f"1PB({max((len(r) for r in rows), default=0)})")
            continue
        a = np.asarray(columns[n])
        if a.dtype.kind in "U S":
            width = a.dtype.itemsize // (4 if a.dtype.kind == "U" else 1)
            a = np.char.encode(a.astype(f"U{width}"), "ascii")
            arrs.append(np.array([x.ljust(width) for x in a], f"S{width}"))
            tforms.append(f"{width}A")
        elif a.ndim == 2:
            base = _TFORM[a.dtype]
            arrs.append(a)
            tforms.append(f"{a.shape[1]}{base}")
        else:
            arrs.append(a)
            tforms.append(f"1{_TFORM[a.dtype]}")
    nrows = 0
    for n, a in zip(names, arrs):
        nrows = max(nrows, len(var_cols[n]) if a is None else len(a))

    # heap layout for variable-length columns: (nelem, offset) pairs
    heap = bytearray()
    var_desc = {}
    for n, rows in var_cols.items():
        desc = np.zeros((nrows, 2), ">i4")
        for i, r in enumerate(rows):
            desc[i] = (len(r), len(heap))
            heap.extend(r.tobytes())
        var_desc[n] = desc

    # build the row-packed recarray (big-endian)
    fields = []
    for n, a in zip(names, arrs):
        if a is None:
            fields.append((n, ">i4", (2,)))
        elif a.dtype.kind == "S":
            fields.append((n, a.dtype))
        elif a.dtype == np.bool_:
            fields.append((n, "S1"))
        elif a.ndim == 2:
            fields.append((n, a.dtype.newbyteorder(">"), (a.shape[1],)))
        else:
            fields.append((n, a.dtype.newbyteorder(">")))
    rec = np.zeros(nrows, dtype=fields)
    for n, a in zip(names, arrs):
        if a is None:
            rec[n] = var_desc[n]
        elif a.dtype == np.bool_:
            rec[n] = np.where(a, b"T", b"F")
        else:
            rec[n] = a

    cards = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", rec.dtype.itemsize),
        _card("NAXIS2", nrows),
        _card("PCOUNT", len(heap)),
        _card("GCOUNT", 1),
        _card("TFIELDS", len(names)),
    ]
    for i, (n, tf) in enumerate(zip(names, tforms)):
        cards.append(_card(f"TTYPE{i + 1}", n))
        cards.append(_card(f"TFORM{i + 1}", tf))
    fh.write(_header_bytes(header, cards))
    raw = rec.tobytes() + bytes(heap)
    fh.write(raw)
    fh.write(b"\x00" * _pad(len(raw)))


def read_fits(path: str):
    """Read all HDUs.  Returns list of (data, Header); table HDUs return
    dict-of-columns data."""
    out = []
    with open_path(path, "rb") as fh:
        while True:
            try:
                h = _read_header(fh)
            except EOFError:
                break
            if h.get("XTENSION", "").strip() == "BINTABLE":
                out.append((_read_table_data(fh, h), h))
            else:
                out.append((_read_image_data(fh, h), h))
            # probe for another HDU
            pos = fh.tell()
            probe = fh.read(CARD)
            if len(probe) < CARD or not probe.strip():
                break
            fh.seek(pos)
    return out


def _read_image_data(fh, h):
    naxis = h.get("NAXIS", 0)
    if naxis == 0:
        return None
    shape = tuple(h[f"NAXIS{i}"] for i in range(naxis, 0, -1))
    bitpix = h["BITPIX"]
    dt = _DTYPES[bitpix]
    n = int(np.prod(shape)) * dt.itemsize
    raw = fh.read(n)
    fh.read(_pad(n))
    data = np.frombuffer(raw, dt).reshape(shape)
    bzero = h.get("BZERO", 0)
    bscale = h.get("BSCALE", 1)
    if bzero == 32768 and bitpix == 16:
        return (data.astype(np.int32) + 32768).astype(np.uint16)
    if bzero or bscale != 1:
        return data.astype(np.float64) * bscale + bzero
    return data.astype(dt.newbyteorder("="))


def _read_table_data(fh, h):
    nrow = h["NAXIS2"]
    rowlen = h["NAXIS1"]
    nf = h["TFIELDS"]
    fields = []
    names = []
    for i in range(1, nf + 1):
        name = str(h[f"TTYPE{i}"]).strip()
        tf = str(h[f"TFORM{i}"]).strip()
        if "P" in tf:                       # variable-length, e.g. 1PB(n)
            fields.append((name, ">i4", (2,)))
            names.append((name, "P", tf[tf.index("P") + 1]))
            continue
        cnt = int(tf[:-1]) if tf[:-1] else 1
        code = tf[-1]
        base = {"E": ">f4", "D": ">f8", "I": ">i2", "J": ">i4",
                "K": ">i8", "B": "u1", "L": "S1", "A": f"S{cnt}"}[code]
        if code == "A":
            fields.append((name, base))
        elif cnt > 1:
            fields.append((name, base, (cnt,)))
        else:
            fields.append((name, base))
        names.append((name, code, cnt))
    raw = fh.read(nrow * rowlen)
    pcount = h.get("PCOUNT", 0)
    heap = fh.read(pcount) if pcount else b""
    fh.read(_pad(nrow * rowlen + pcount))
    rec = np.frombuffer(raw, dtype=fields, count=nrow)
    out = {}
    for name, code, cnt in names:
        a = rec[name]
        if code == "P":
            rows = []
            for nelem, off in a.astype("=i4"):
                rows.append(np.frombuffer(
                    heap[off:off + nelem], np.uint8))
            out[name] = rows
        elif code == "L":
            out[name] = a == b"T"
        elif code == "A":
            out[name] = np.char.decode(a, "ascii")
        else:
            out[name] = a.astype(a.dtype.newbyteorder("="))
    return out
