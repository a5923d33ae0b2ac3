"""The msgpack subset of flax's ``serialization.to_bytes`` and
``msgpack_restore``, in Python and numpy.

The JAX package saves network parameters with flax: a msgpack map of
str keys whose leaves are arrays, each an extension of type 1 whose
payload is itself msgpack of ``(shape, dtype name, C-order bytes)``.
This module reads and writes that format without flax, which the
card's machine lacks, and without ``msgpack``, even where it imports,
so every machine takes the same path.

Supported: nil, bool, ints of every width, float32/64, str, bin, array
and map (str keys, in their order) in each of their fix/8/16/32 forms,
and flax's extension types 1 (ndarray), 2 (native complex) and 3
(numpy scalar).  :func:`encode` writes what flax's
``msgpack_serialize`` writes (``msgpack.packb(tree,
use_bin_type=True, strict_types=True)`` with flax's extension hook), so
for a tree of dicts in the same key order its bytes are those of
``flax.serialization.to_bytes``.  The one difference: ``to_bytes``
first turns a list into a map keyed "0", "1", ..., where this writes a
list (and a tuple) as an array, as ``msgpack_serialize`` writes a list.
Anything else raises ``ValueError`` naming the type byte and its
offset, and so do flax's chunked arrays (leaves over 2**30 bytes, which
the networks never reach).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30                 # flax's chunking threshold
CHUNK_MARKER = "__msgpack_chunked_array__"

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ------------------------------------------------------------ encoding

def _int(v: int) -> bytes:
    if -32 <= v < 128:
        return struct.pack("b" if v < 0 else "B", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _sized(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form
    below ``fix_max``, else the smallest of ``codes`` (8, 16, 32 bits;
    None where the family has no such width)."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} items is too many")


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code]) + payload
    for c, fmt, top in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                        (0xC9, ">I", 1 << 32)):
        if n < top:
            return bytes([c]) + struct.pack(fmt, n) + bytes([code]) + payload
    raise ValueError(f"msgpack: extension of {n} bytes is too long")


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"msgpack: cannot write an array of {a.dtype}")
    if a.size * a.dtype.itemsize > MAX_CHUNK_SIZE:
        raise ValueError(
            f"msgpack: an array of {a.size * a.dtype.itemsize} bytes is over "
            f"flax's 2**30-byte limit, which flax writes as a chunked array "
            f"({CHUNK_MARKER}); not supported")
    return encode((tuple(int(s) for s in a.shape), a.dtype.name,
                   a.tobytes("C")))


def _pack(x, out: list) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        out.append(_int(x))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        b = x.encode("utf-8")
        out.append(_sized(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b)
    elif t in (bytes, bytearray, memoryview):
        b = bytes(x)
        out.append(_sized(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b)
    elif t in (list, tuple):
        out.append(_sized(len(x), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif t is dict:
        out.append(_sized(len(x), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif t is complex:
        out.append(_ext(EXT_COMPLEX, encode((x.real, x.imag))))
    else:
        raise ValueError(f"msgpack: cannot write a {t.__name__}")


def encode(tree) -> bytes:
    """``tree`` (dicts, lists, tuples, scalars, numpy arrays and
    scalars) as flax's msgpack bytes."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ------------------------------------------------------------ decoding

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw          # str as bytes (flax's ndarray payloads)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at offset {self.pos} "
                             f"(wants {n} bytes, {len(self.data) - self.pos} "
                             f"left)")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int, at: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from(payload, at)
        if code == EXT_NPSCALAR:
            return _ndarray_from(payload, at)[()]
        if code == EXT_COMPLEX:
            re_im = decode(payload)
            if not (isinstance(re_im, list) and len(re_im) == 2):
                raise ValueError(f"msgpack: bad complex at offset {at}")
            return complex(re_im[0], re_im[1])
        raise ValueError(f"msgpack: extension type {code} at offset {at} "
                         f"is not one of flax's (1, 2, 3)")

    def obj(self):
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return self.ext(code, n, at)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4), at)
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"), at)
        raise ValueError(f"msgpack: type byte 0x{b:02x} at offset {at} is "
                         f"not in flax's subset")

    def map_(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            kat = self.pos
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: map key of type "
                                 f"{type(k).__name__} at offset {kat}")
            if k == CHUNK_MARKER:
                raise ValueError(
                    f"msgpack: a flax chunked array ({CHUNK_MARKER}, an "
                    f"array over 2**30 bytes) in the map at offset {at}; "
                    f"not supported")
            out[k] = self.obj()
        return out


def _ndarray_from(payload: bytes, at: int) -> np.ndarray:
    r = _Reader(payload, raw=True)
    tpl = r.obj()
    if r.pos != len(payload) or not (
            isinstance(tpl, list) and len(tpl) == 3
            and isinstance(tpl[0], list) and isinstance(tpl[1], bytes)
            and isinstance(tpl[2], bytes)):
        raise ValueError(f"msgpack: malformed ndarray extension at offset "
                         f"{at}")
    shape, name, buf = tpl
    try:
        dtype = np.dtype(name.decode("ascii"))
    except TypeError as e:
        raise ValueError(f"msgpack: dtype {name!r} at offset {at} is not a "
                         f"numpy dtype") from e
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError(f"msgpack: ndarray at offset {at} holds {len(buf)} "
                         f"bytes, not {count} x {dtype}")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def decode(data: bytes):
    """flax's msgpack bytes as a tree: dicts (str keys, file order),
    lists, scalars and numpy arrays."""
    r = _Reader(bytes(data), raw=False)
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         f"object, at offset {r.pos}")
    return tree
