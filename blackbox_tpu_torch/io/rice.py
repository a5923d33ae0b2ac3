"""Rice tile compression: fpack/funpack parity on top of the C++ codec.

The reference fpacks every image product with content-dependent
quantisation — q=2 for Scorr/limmag, q=4 for Fpsf, q=16 otherwise, Rice
for everything (reference blackbox.py:812-857).  Here the codec is
the native C++ RICE_1 implementation in ``csrc/rice.cpp`` (built on
first use with g++; a numpy fallback keeps the path alive without a
toolchain), and images are stored with the FITS tile-compression
convention: a BINTABLE with ZIMAGE/ZCMPTYPE keywords, one row per tile,
variable-length COMPRESSED_DATA plus per-tile ZSCALE/ZZERO for
quantised floats.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from blackbox_tpu_torch.io.fits import Header, read_fits

_LIB = None
_LIB_TRIED = False


def _build_lib():
    """Compile csrc/rice.cpp into the package's ``_build/`` directory
    (listed in ``.gitignore``; never into the source tree), cached
    until the source changes.  The library is written under a private
    name and renamed into place, so processes building at once never
    load a half-written file."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "csrc", "rice.cpp")
    build = os.path.join(os.path.dirname(here), "_build")
    out = os.path.join(build, "rice.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(build, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o",
               tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _get_lib():
    global _LIB, _LIB_TRIED
    if _LIB is None and not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(_build_lib())
            for suff, ct in (("i4", ctypes.c_int32), ("i2", ctypes.c_int16),
                             ("i1", ctypes.c_uint8)):
                enc = getattr(lib, f"rice_encode_{suff}")
                enc.restype = ctypes.c_long
                enc.argtypes = [ctypes.POINTER(ct), ctypes.c_long,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_long]
                dec = getattr(lib, f"rice_decode_{suff}")
                dec.restype = ctypes.c_long
                dec.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_long, ctypes.POINTER(ct),
                                ctypes.c_long]
            _LIB = lib
        except Exception:
            _LIB = None
    return _LIB


def coder() -> str:
    """Which Rice coder encodes and decodes: ``"compiled"`` (the C++
    library of csrc/rice.cpp) or ``"numpy"`` (the fallback, taken when
    the library cannot be built or loaded)."""
    return "compiled" if _get_lib() is not None else "numpy"


_SUFF = {np.dtype(np.int32): ("i4", ctypes.c_int32),
         np.dtype(np.int16): ("i2", ctypes.c_int16),
         np.dtype(np.uint8): ("i1", ctypes.c_uint8)}


# ---------------------------------------------------------------- codec

def rice_encode(a: np.ndarray) -> bytes:
    """Rice-encode a 1-D int32/int16/uint8 array."""
    a = np.ascontiguousarray(a)
    suff, ct = _SUFF[a.dtype]
    lib = _get_lib()
    if lib is not None:
        cap = a.nbytes + a.size // 4 + 64
        out = np.empty(cap, np.uint8)
        n = getattr(lib, f"rice_encode_{suff}")(
            a.ctypes.data_as(ctypes.POINTER(ct)), a.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise ValueError("rice encode overflow")
        return out[:n].tobytes()
    return _np_encode(a)


def rice_decode(buf: bytes, n: int, dtype) -> np.ndarray:
    """Decode ``n`` values of ``dtype`` from a Rice stream."""
    dtype = np.dtype(dtype)
    suff, ct = _SUFF[dtype]
    lib = _get_lib()
    if lib is not None:
        src = np.frombuffer(buf, np.uint8)
        out = np.empty(n, dtype)
        used = getattr(lib, f"rice_decode_{suff}")(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
            out.ctypes.data_as(ctypes.POINTER(ct)), n)
        if used < 0:
            raise ValueError("rice decode: corrupt stream")
        return out
    return _np_decode(buf, n, dtype)


# ------------------------------------------- numpy fallback (slow path)

_FSBITS = {4: (5, 25, 32), 2: (4, 14, 16), 1: (3, 6, 8)}


def _np_encode(a: np.ndarray) -> bytes:
    # modular (mod 2^w) difference + zigzag arithmetic, like the C++ side
    fsbits, fsmax, bbits = _FSBITS[a.itemsize]
    mod = 1 << bbits
    half = mod >> 1
    bits = []
    x = a.astype(np.int64) & (mod - 1)
    first = int(x[0])
    bits.append(format(first, f"0{bbits}b"))
    d = np.diff(x) & (mod - 1)
    neg = d >= half                       # top bit set = "negative"
    u = np.where(neg, (~(d << 1)) & (mod - 1), (d << 1) & (mod - 1))
    u = u.astype(np.uint64)
    for s in range(0, len(u), 32):
        blk = u[s:s + 32]
        tot = int(blk.sum())
        if tot == 0:
            bits.append("0" * fsbits)
            continue
        psum = (tot - len(blk) // 2 - 1) // len(blk)
        fs = 0
        while psum > 0:
            psum >>= 1
            fs += 1
        if fs >= fsmax:
            bits.append(format(fsmax + 1, f"0{fsbits}b"))
            for v in blk:
                bits.append(format(int(v) & ((1 << bbits) - 1),
                                   f"0{bbits}b"))
        else:
            bits.append(format(fs + 1, f"0{fsbits}b"))
            for v in blk:
                q = int(v) >> fs
                bits.append("0" * q + "1")
                if fs:
                    bits.append(format(int(v) & ((1 << fs) - 1),
                                       f"0{fs}b"))
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def _np_decode(buf: bytes, n: int, dtype) -> np.ndarray:
    fsbits, fsmax, bbits = _FSBITS[np.dtype(dtype).itemsize]
    s = bin(int.from_bytes(buf, "big"))[2:].zfill(len(buf) * 8)
    pos = 0

    def take(k):
        nonlocal pos
        v = int(s[pos:pos + k], 2)
        pos += k
        return v

    mod = 1 << bbits
    out = np.zeros(n, np.int64)
    last = take(bbits)
    out[0] = last
    i = 1
    while i < n:
        m = min(32, n - i)
        code = take(fsbits)
        if code == 0:
            out[i:i + m] = last
            i += m
            continue
        for j in range(m):
            if code == fsmax + 1:
                u = take(bbits)
            else:
                fs = code - 1
                q = 0
                while s[pos] == "0":
                    q += 1
                    pos += 1
                pos += 1
                u = (q << fs) | (take(fs) if fs else 0)
            d = (~(u >> 1)) & (mod - 1) if (u & 1) else (u >> 1)
            last = (last + d) & (mod - 1)
            out[i + j] = last
        i += m
    # reinterpret the w-bit pattern in the target dtype
    udt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[np.dtype(dtype).itemsize]
    return out.astype(udt).view(dtype).copy()


# ------------------------------------------------- tile-compressed FITS

def _quantize(tile: np.ndarray, q: float):
    """fpack-style quantisation: zscale = sigma/q from the tile's MAD."""
    finite = np.isfinite(tile)
    vals = tile[finite]
    if vals.size < 4:
        return np.zeros(tile.shape, np.int32), 1.0, 0.0
    med = float(np.median(vals))
    sigma = float(np.median(np.abs(vals - med))) * 1.4826
    if sigma <= 0:
        sigma = max(abs(med) * 1e-6, 1e-6)
    zscale = sigma / q
    zzero = med
    ints = np.round((np.where(finite, tile, med) - zzero) / zscale)
    ints = np.clip(ints, -2 ** 31 + 1, 2 ** 31 - 1).astype(np.int32)
    return ints, zscale, zzero


def write_rice(path: str, data: np.ndarray, header: Header | None = None,
               qlevel: float = 16.0, tile_rows: int = 128):
    """Write an image as a RICE_1 tile-compressed FITS file.

    Integer images compress losslessly; float32 images are quantised at
    ``qlevel`` (reference q=2 Scorr/limmag, q=4 Fpsf, q=16 default).
    """
    from blackbox_tpu_torch.io.fits import write_image

    h = (header or Header()).copy()
    H, W = data.shape
    isfloat = data.dtype.kind == "f"
    zbitpix = -32 if isfloat else {1: 8, 2: 16, 4: 32}[data.dtype.itemsize]
    comp, zscales, zzeros = [], [], []
    for y0 in range(0, H, tile_rows):
        tile = data[y0:y0 + tile_rows]
        if isfloat:
            ints, zs, zz = _quantize(tile.astype(np.float64), qlevel)
        else:
            ints, zs, zz = tile.astype(np.int32), 1.0, 0.0
        comp.append(rice_encode(ints.ravel()))
        zscales.append(zs)
        zzeros.append(zz)

    h["ZIMAGE"] = (True, "tile-compressed image")
    h["ZCMPTYPE"] = ("RICE_1", "compression algorithm")
    h["ZBITPIX"] = (zbitpix, "original BITPIX")
    h["ZNAXIS"] = (2, "")
    h["ZNAXIS1"] = (W, "")
    h["ZNAXIS2"] = (H, "")
    h["ZTILE1"] = (W, "tile width")
    h["ZTILE2"] = (tile_rows, "tile rows")
    h["ZNAME1"] = ("BLOCKSIZE", "")
    h["ZVAL1"] = (32, "")
    h["ZNAME2"] = ("BYTEPIX", "")
    h["ZVAL2"] = (4, "")
    if isfloat:
        h["ZQUANTIZ"] = ("NO_DITHER", "quantisation method")
        h["ZQLEVEL"] = (qlevel, "quantisation level")

    cols = {"COMPRESSED_DATA": comp,
            "ZSCALE": np.asarray(zscales, np.float64),
            "ZZERO": np.asarray(zzeros, np.float64)}
    from blackbox_tpu_torch.io.storage import get_backend
    get_backend(path).make_dir(os.path.dirname(path))
    from blackbox_tpu_torch.io.fits import (_write_image_hdu, _write_table_hdu,
                                      open_path)
    with open_path(path, "wb") as fh:
        _write_image_hdu(fh, None, Header(), primary=True, extend=True)
        _write_table_hdu(fh, cols, h)


def read_rice(path: str):
    """Read a RICE_1 tile-compressed FITS file -> (image, Header)."""
    hdus = read_fits(path)
    for data, h in hdus:
        if isinstance(data, dict) and h.get("ZIMAGE"):
            H = int(h["ZNAXIS2"])
            W = int(h["ZNAXIS1"])
            tr = int(h["ZTILE2"])
            zbitpix = int(h["ZBITPIX"])
            out = np.empty((H, W),
                           np.float32 if zbitpix < 0 else
                           {8: np.uint8, 16: np.int16, 32: np.int32}
                           [zbitpix])
            zs = np.atleast_1d(data.get("ZSCALE", [1.0]))
            zz = np.atleast_1d(data.get("ZZERO", [0.0]))
            for i, buf in enumerate(data["COMPRESSED_DATA"]):
                y0 = i * tr
                rows = min(tr, H - y0)
                ints = rice_decode(bytes(buf), rows * W, np.int32)
                tile = ints.reshape(rows, W)
                if zbitpix < 0:
                    out[y0:y0 + rows] = tile * zs[i] + zz[i]
                else:
                    out[y0:y0 + rows] = tile.astype(out.dtype)
            return out, h
    raise ValueError(f"{path}: no ZIMAGE HDU found")
