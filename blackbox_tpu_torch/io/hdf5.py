"""A read-only HDF5 reader for keras weight files, in Python and numpy.

The production ASTA U-Net is a keras 2 HDF5 file.  The card's machine
has no ``h5py``, so the port reads such files itself, following the
public "HDF5 File Format Specification Version 3.0" for the structures
that h5py (default ``libver``) and keras 2 write:

- superblock versions 0 and 1, a user block included;
- version 1 object headers and their continuation blocks;
- symbol-table groups: version 1 B-tree nodes of type 0, ``SNOD``
  nodes and the names in the local ``HEAP``;
- dataspace messages versions 1 and 2;
- datatypes of class 0 (fixed-point), 1 (IEEE float, either byte
  order), 3 (fixed-length string) and 9 (variable-length string, from
  the global heap ``GCOL``);
- attribute messages versions 1 to 3;
- data layout version 3: compact, contiguous, and chunked without a
  filter pipeline (version 1 B-tree nodes of type 1).

Everything else raises ``ValueError`` naming the structure: superblock
versions 2 and 3, version 2 object headers (``OHDR``), link messages,
fractal heaps and dense attribute storage (all ``libver="latest"``),
any filter pipeline (a compressed dataset), shared messages, other
datatype classes, and keras 3's zipped ``.keras`` files.

:func:`open` returns the root :class:`Group`; a group supports ``in``,
``[]`` (``/`` paths), iteration, ``.attrs`` and ``visititems`` in the
name order h5py gives; ``np.asarray`` reads a :class:`Dataset`.  Values
come back as h5py returns them: attributes of variable-length strings
as ``str`` (object arrays of ``str``), fixed-length strings as numpy
``S`` arrays, numbers in the file's byte order, scalars as numpy
scalars.
"""

from __future__ import annotations

import builtins

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE = 0x1, 0x2, 0x3
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS = 0x6, 0x8, 0xA, 0xB
_ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0xC, 0x10, 0x11
_ATTRIBUTE_INFO = 0x15

_REFUSED_MESSAGES = {
    _LINK_INFO: "a link info message (new-style group, libver='latest')",
    _LINK: "a link message (new-style group, libver='latest')",
    _GROUP_INFO: "a group info message (new-style group, libver='latest')",
    _FILTERS: "a filter pipeline (a compressed or filtered dataset)",
}


class _File:
    """The file's bytes and the sizes its superblock sets."""

    def __init__(self, data: bytes, path: str):
        self.data = data
        self.path = path
        if data[:4] == b"PK\x03\x04":
            raise ValueError(f"{path}: a zip archive (a keras 3 .keras "
                             f"file), not HDF5; not supported")
        at = 0
        while data[at:at + 8] != _SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(data):
                raise ValueError(f"{path}: no HDF5 superblock signature")
        version = data[at + 8]
        if version not in (0, 1):
            raise ValueError(f"{path}: superblock version {version} "
                             f"(HDF5 1.8's format or later, as h5py's "
                             f"libver='latest' writes); only versions 0 "
                             f"and 1 are supported")
        self.so = data[at + 13]             # size of offsets
        self.sl = data[at + 14]             # size of lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"{path}: offsets of {self.so} and lengths of "
                             f"{self.sl} bytes")
        p = at + 24 + (4 if version == 1 else 0)
        self.base = self.offset(p)
        p += 4 * self.so                    # base, free space, EOF, driver
        self.root_header = self.offset(p + self.so)   # root symbol entry

    def need(self, at: int, n: int, what: str) -> None:
        if at < 0 or at + n > len(self.data):
            raise ValueError(f"{self.path}: {what} at {at} runs past the "
                             f"end of the file ({len(self.data)} bytes)")

    def uint(self, at: int, n: int) -> int:
        self.need(at, n, "a field")
        return int.from_bytes(self.data[at:at + n], "little")

    def offset(self, at: int) -> int:
        return self.uint(at, self.so)

    def length(self, at: int) -> int:
        return self.uint(at, self.sl)

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    def addr(self, a: int) -> int:
        return self.base + a

    def signature(self, at: int, sig: bytes, what: str) -> None:
        self.need(at, 4, what)
        if self.data[at:at + 4] != sig:
            raise ValueError(f"{self.path}: {what} at {at} lacks its "
                             f"{sig.decode()} signature")

    # ------------------------------------------------- object headers

    def messages(self, addr: int):
        """(type, flags, data) of each message of the object header at
        file address ``addr``, continuation blocks followed."""
        at = self.addr(addr)
        self.need(at, 16, "an object header")
        if self.data[at:at + 4] == b"OHDR":
            raise ValueError(f"{self.path}: a version 2 object header "
                             f"(OHDR: libver='latest' or track_order) at "
                             f"{at}; not supported")
        if self.data[at] != 1:
            raise ValueError(f"{self.path}: object header version "
                             f"{self.data[at]} at {at}")
        count = self.uint(at + 2, 2)
        blocks = [(at + 16, self.uint(at + 8, 4))]
        out = []
        while blocks and len(out) < count:
            p, n = blocks.pop(0)
            self.need(p, n, "an object header block")
            end = p + n
            while p + 8 <= end and len(out) < count:
                mtype = self.uint(p, 2)
                size = self.uint(p + 2, 2)
                flags = self.data[p + 4]
                body = p + 8
                if body + size > end:
                    raise ValueError(f"{self.path}: header message at {p} "
                                     f"runs past its block")
                if flags & 0x02:
                    raise ValueError(f"{self.path}: a shared header message "
                                     f"(type {mtype}) at {p}; not supported")
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(self.offset(body)),
                                   self.length(body + self.so)))
                out.append((mtype, flags, body, size))
                p = body + size
        return out

    # --------------------------------------------------------- groups

    def heap_name(self, heap_data: int, offset: int) -> bytes:
        at = heap_data + offset
        self.need(at, 1, "a link name")
        end = self.data.find(b"\0", at)
        if end < 0:
            raise ValueError(f"{self.path}: unterminated name at {at}")
        return bytes(self.data[at:end])

    def group_links(self, btree: int, heap: int):
        """{name: object header address} of a symbol-table group."""
        hp = self.addr(heap)
        self.signature(hp, b"HEAP", "a local heap")
        heap_data = self.addr(self.offset(hp + 8 + 2 * self.sl))
        links = {}
        for node in self.btree_children(btree, 0):
            sn = self.addr(node)
            self.signature(sn, b"SNOD", "a symbol table node")
            n = self.uint(sn + 6, 2)
            p = sn + 8
            for _ in range(n):
                name = self.heap_name(heap_data, self.offset(p))
                links[name.decode("utf-8")] = self.offset(p + self.so)
                p += 2 * self.so + 24
        return links

    def btree_children(self, addr: int, node_type: int, rank: int = 0):
        """The leaves of the version 1 B-tree at ``addr``: SNOD addresses
        (type 0), or (offsets, size, filter mask, address) of each chunk
        (type 1, ``rank`` + 1 offsets a key)."""
        at = self.addr(addr)
        self.signature(at, b"TREE", "a B-tree node")
        if self.data[at + 4] != node_type:
            raise ValueError(f"{self.path}: B-tree node at {at} has type "
                             f"{self.data[at + 4]}, {node_type} expected")
        level = self.data[at + 5]
        used = self.uint(at + 6, 2)
        key = self.sl if node_type == 0 else 8 + 8 * (rank + 1)
        p = at + 8 + 2 * self.so
        out = []
        for _ in range(used):
            child = self.offset(p + key)
            if level > 0:
                out += self.btree_children(child, node_type, rank)
            elif node_type == 0:
                out.append(child)
            else:
                size = self.uint(p, 4)
                mask = self.uint(p + 4, 4)
                offs = tuple(self.uint(p + 8 + 8 * i, 8)
                             for i in range(rank + 1))
                out.append((offs, size, mask, child))
            p += key + self.so
        return out

    # ------------------------------------------- dataspaces and types

    def dataspace(self, at: int):
        """The shape a dataspace message gives (None for a null one)."""
        version, rank = self.data[at], self.data[at + 1]
        if version == 1:
            p = at + 8
        elif version == 2:
            if self.data[at + 3] == 2:
                return None
            p = at + 4
        else:
            raise ValueError(f"{self.path}: dataspace version {version} at "
                             f"{at}")
        return tuple(self.length(p + i * self.sl) for i in range(rank))

    def datatype(self, at: int):
        """(numpy dtype, vlen-string?, bytes an element) of a datatype
        message."""
        cls, version = self.data[at] & 0x0F, self.data[at] >> 4
        bits = self.uint(at + 1, 3)
        size = self.uint(at + 4, 4)
        if cls == 0:                            # fixed-point
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 0x08 else "u"
            if size not in (1, 2, 4, 8):
                raise ValueError(f"{self.path}: integer of {size} bytes")
            return np.dtype(f"{order}{kind}{size}"), False, size
        if cls == 1:                            # IEEE float
            if bits & 0x40:
                raise ValueError(f"{self.path}: VAX-order float at {at}")
            if size not in (2, 4, 8):
                raise ValueError(f"{self.path}: float of {size} bytes")
            return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), False, size
        if cls == 3:                            # fixed-length string
            return np.dtype(f"S{size}"), False, size
        if cls == 9:                            # variable length
            if bits & 0x0F != 1:
                raise ValueError(f"{self.path}: a variable-length sequence "
                                 f"(not a string) at {at}; not supported")
            return np.dtype(object), True, size
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 10: "array"}
        raise ValueError(f"{self.path}: datatype class {cls} "
                         f"({names.get(cls, 'unknown')}, version {version}) "
                         f"at {at}; not supported")

    def vlen_strings(self, raw: bytes, n: int) -> list:
        """The ``n`` variable-length strings whose heap IDs ``raw``
        holds, as bytes."""
        step = 4 + self.so + 4
        out = []
        for i in range(n):
            p = i * step
            length = int.from_bytes(raw[p:p + 4], "little")
            coll = int.from_bytes(raw[p + 4:p + 4 + self.so], "little")
            index = int.from_bytes(raw[p + 4 + self.so:p + step], "little")
            out.append(b"" if length == 0 and coll == 0
                       else self.global_object(coll, index)[:length])
        return out

    def global_object(self, coll: int, index: int) -> bytes:
        at = self.addr(coll)
        self.signature(at, b"GCOL", "a global heap collection")
        end = at + self.length(at + 8)
        p = at + 8 + self.sl
        while p + 8 + self.sl <= end:
            idx = self.uint(p, 2)
            size = self.length(p + 8)
            if idx == 0:
                break
            data = p + 8 + self.sl
            if idx == index:
                self.need(data, size, "a global heap object")
                return bytes(self.data[data:data + size])
            p = data + (size + 7) // 8 * 8
        raise ValueError(f"{self.path}: global heap object {index} not in "
                         f"the collection at {at}")

    def values(self, raw: bytes, shape, dtype, vlen: bool, decode: bool):
        """The array of ``shape`` that ``raw`` holds; variable-length
        strings as an object array (of str if ``decode``)."""
        n = int(np.prod(shape, dtype=np.int64))
        if vlen:
            items = self.vlen_strings(raw, n)
            a = np.empty(n, dtype=object)
            a[:] = [s.decode("utf-8") for s in items] if decode else items
            return a.reshape(shape)
        if len(raw) < n * dtype.itemsize:
            raise ValueError(f"{self.path}: {len(raw)} bytes for {n} x "
                             f"{dtype}")
        return np.frombuffer(raw, dtype=dtype, count=n).reshape(shape).copy()

    # ------------------------------------------------------ attributes

    def attribute(self, at: int):
        """(name, value) of an attribute message."""
        version = self.data[at]
        if version not in (1, 2, 3):
            raise ValueError(f"{self.path}: attribute message version "
                             f"{version} at {at}")
        if version > 1 and self.data[at + 1] & 0x03:
            raise ValueError(f"{self.path}: an attribute with a shared "
                             f"datatype or dataspace at {at}; not supported")
        nname, ntype, nspace = (self.uint(at + 2, 2), self.uint(at + 4, 2),
                                self.uint(at + 6, 2))
        pad = (lambda n: (n + 7) // 8 * 8) if version == 1 else \
            (lambda n: n)
        p = at + 8 + (1 if version == 3 else 0)
        name = bytes(self.data[p:p + nname]).rstrip(b"\0").decode("utf-8")
        p += pad(nname)
        dtype, vlen, isz = self.datatype(p)
        p += pad(ntype)
        shape = self.dataspace(p)
        p += pad(nspace)
        if shape is None:
            return name, None
        size = int(np.prod(shape, dtype=np.int64)) * isz
        self.need(p, size, "attribute data")
        a = self.values(bytes(self.data[p:p + size]), shape, dtype, vlen,
                        decode=True)
        return name, (a[()] if shape == () else a)


class _Object:
    def __init__(self, f: _File, addr: int, name: str, msgs):
        self._f = f
        self.addr = addr
        self.name = name
        attrs = {}
        for mtype, _, body, _ in msgs:
            if mtype == _ATTRIBUTE:
                k, v = f.attribute(body)
                attrs[k] = v
            elif mtype == _ATTRIBUTE_INFO:
                heap = f.offset(body + 2 + (2 if f.data[body + 1] & 1 else 0))
                if not f.undefined(heap):
                    raise ValueError(f"{f.path}: dense attribute storage (a "
                                     f"fractal heap) on {name}; not "
                                     f"supported")
            elif mtype in _REFUSED_MESSAGES:
                raise ValueError(f"{f.path}: {_REFUSED_MESSAGES[mtype]} on "
                                 f"{name}; not supported")
        # h5py's order: by name
        self.attrs = dict(sorted(attrs.items(),
                                 key=lambda kv: kv[0].encode("utf-8")))


class Dataset(_Object):
    """An array in the file; ``np.asarray`` reads it."""

    def __init__(self, f, addr, name, msgs):
        super().__init__(f, addr, name, msgs)
        by_type = {m[0]: m for m in msgs}
        self.shape = f.dataspace(by_type[_DATASPACE][2])
        self.dtype, self._vlen, self._isz = f.datatype(
            by_type[_DATATYPE][2])
        self._layout = by_type[_LAYOUT][2]
        if self.shape is None:
            raise ValueError(f"{f.path}: dataset {name} has a null "
                             f"dataspace; not supported")

    def _raw(self) -> bytes:
        f, at = self._f, self._layout
        version, cls = f.data[at], f.data[at + 1]
        if version != 3:
            raise ValueError(f"{f.path}: data layout version {version} on "
                             f"{self.name}; only version 3 is supported")
        n = int(np.prod(self.shape, dtype=np.int64)) * self._isz
        if cls == 0:                                     # compact
            size = f.uint(at + 2, 2)
            f.need(at + 4, size, "compact data")
            return bytes(f.data[at + 4:at + 4 + size])
        if cls == 1:                                     # contiguous
            addr = f.offset(at + 2)
            if f.undefined(addr):
                return bytes(n)                          # never written
            f.need(f.addr(addr), n, "contiguous data")
            return bytes(f.data[f.addr(addr):f.addr(addr) + n])
        if cls == 2:
            return self._chunked(at, n)
        raise ValueError(f"{f.path}: data layout class {cls} on "
                         f"{self.name}; not supported")

    def _chunked(self, at: int, n: int) -> bytes:
        f = self._f
        ndims = f.data[at + 2]
        addr = f.offset(at + 3)
        dims = [f.uint(at + 3 + f.so + 4 * i, 4) for i in range(ndims)]
        chunk, isz = dims[:-1], dims[-1]
        rank = len(self.shape)
        if len(chunk) != rank or isz != self._isz:
            raise ValueError(f"{f.path}: chunk dims {dims} for {self.name} "
                             f"{self.shape}")
        out = np.zeros(self.shape + (isz,), np.uint8)
        if f.undefined(addr):
            return out.tobytes()
        csize = int(np.prod(chunk, dtype=np.int64)) * isz
        for offs, size, mask, caddr in f.btree_children(addr, 1, rank):
            if mask or size != csize:
                raise ValueError(f"{f.path}: a filtered chunk in "
                                 f"{self.name}; not supported")
            f.need(f.addr(caddr), csize, "a chunk")
            block = np.frombuffer(f.data, np.uint8, csize, f.addr(caddr)) \
                .reshape(tuple(chunk) + (isz,))
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out.tobytes()

    def __array__(self, dtype=None, copy=None):
        a = self._f.values(self._raw(), self.shape, self.dtype, self._vlen,
                           decode=False)
        return a if dtype is None else a.astype(dtype)


class Group(_Object):
    """A symbol-table group: its members by name, in name order."""

    def __init__(self, f, addr, name, msgs, table):
        super().__init__(f, addr, name, msgs)
        links = f.group_links(f.offset(table), f.offset(table + f.so))
        self._links = dict(sorted(links.items(),
                                  key=lambda kv: kv[0].encode("utf-8")))

    def __iter__(self):
        return iter(self._links)

    def _walk(self, path: str):
        node = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group) or part not in node._links:
                return None
            node = _object(self._f, node._links[part],
                           node.name.rstrip("/") + "/" + part)
        return node

    def __contains__(self, path):
        return self._walk(path) is not None

    def __getitem__(self, path):
        node = self._walk(path)
        if node is None:
            raise KeyError(f"{path!r} not in {self.name}")
        return node

    def visititems(self, func):
        """``func(path, object)`` for every object below the group, each
        once, depth first in name order (h5py's ``visititems``); stops
        at the first call that returns something other than None."""
        seen = {self.addr}

        def visit(group, prefix):
            for k, addr in group._links.items():
                if addr in seen:
                    continue
                seen.add(addr)
                path = prefix + k
                obj = group[k]
                ret = func(path, obj)
                if ret is not None:
                    return ret
                if isinstance(obj, Group):
                    ret = visit(obj, path + "/")
                    if ret is not None:
                        return ret
            return None

        return visit(self, "")


def _object(f: _File, addr: int, name: str):
    msgs = f.messages(addr)
    for mtype, _, body, _ in msgs:
        if mtype == _SYMBOL_TABLE:
            return Group(f, addr, name, msgs, body)
    if any(m[0] == _LAYOUT for m in msgs):
        return Dataset(f, addr, name, msgs)
    for mtype, _, _, _ in msgs:
        if mtype in _REFUSED_MESSAGES:
            raise ValueError(f"{f.path}: {_REFUSED_MESSAGES[mtype]} on "
                             f"{name}; not supported")
    raise ValueError(f"{f.path}: object {name} at {addr} is neither a "
                     f"symbol-table group nor a dataset")


def open(path: str) -> Group:  # noqa: A001  (h5py.File's role)
    """The root group of the HDF5 file at ``path``, read into memory."""
    with builtins.open(path, "rb") as fh:
        data = fh.read()
    f = _File(data, str(path))
    root = _object(f, f.root_header, "/")
    if not isinstance(root, Group):
        raise ValueError(f"{path}: the root object is not a group")
    return root
