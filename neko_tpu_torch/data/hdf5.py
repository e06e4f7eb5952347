"""A numpy reader for the subset of HDF5 that h5py writes with its default
file format (libver ('earliest', 'v114')): what the JAX package's `save_h5`
produces, and what `H5EpisodeDataset` reads here without h5py; and a numpy
writer (`write_h5`, under `data/episodes.py`'s `save_h5`) of a part of that
subset, which h5py, the JAX package and this reader all read.

What it reads:

* superblock version 0, with 8-byte offsets and lengths;
* version 1 object headers, following continuation messages (0x10);
* groups stored as symbol tables (message 0x11): a version 1 B-tree of
  node type 0 over symbol nodes (`SNOD`), names in the local heap
  (`HEAP`), of any depth;
* dataspace (0x1) version 1, datatype (0x3), fill value (0x5) version 2,
  layout (0x8) version 3 and attribute (0xC) version 1 messages;
  modification times (0x12) and NIL messages are skipped;
* datatypes: fixed-point (signed or unsigned, 1/2/4/8 bytes, either byte
  order), IEEE floats (2/4/8 bytes), and variable-length strings through
  the global heap (`GCOL`);
* layouts: compact, contiguous (an undefined address, which h5py leaves
  until the first write, reads as the fill value) and chunked (a version 1
  B-tree of node type 1, edge chunks included).

What raises, naming the feature: a filter pipeline (gzip/deflate, shuffle,
szip, lzf, any other), enum types (h5py's bool), compound, reference and
other types, shared messages, a superblock of version 1 or later, version 2
object headers (`OHDR`), other versions of the messages above, and
new-style (link message / fractal-heap) group storage.

Reads happen on demand with `os.pread` on one read-only descriptor, so
threads may read one `H5File` at once: nothing keeps a file position.

What `write_h5` writes: superblock version 0 (8-byte offsets and lengths,
group leaf K 4, internal K 16, as h5py's default), version 1 object headers,
symbol-table groups (a version 1 B-tree of node type 0 over `SNOD`s, the
names in a `HEAP`), contiguous datasets of the fixed-point (1/2/4/8 bytes)
and IEEE float (2/4/8 bytes) types in either byte order, and root
attributes of those types or of variable-length UTF-8 strings (one global
heap collection, `GCOL`, as h5py writes a `str`).  Anything else (bool,
which h5py writes as an enum; complex, object or fixed-length string
arrays) raises `UnsupportedHDF5`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_FILTERS = {1: "gzip/deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "nbit", 6: "scaleoffset", 32000: "lzf"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum (h5py's bool)", 10: "array"}


class UnsupportedHDF5(NotImplementedError):
    """A feature of the file lies outside the subset this reader takes."""


def _u(buf, off: int, n: int) -> int:
    return int.from_bytes(buf[off:off + n], "little")


class _Datatype:
    """A datatype message: the numpy dtype, or a variable-length string."""

    def __init__(self, dtype: Optional[np.dtype], vlen_str: bool = False):
        self.dtype, self.vlen_str = dtype, vlen_str


def _parse_datatype(buf, off: int) -> _Datatype:
    cls, version = buf[off] & 0x0F, buf[off] >> 4
    bits = _u(buf, off + 1, 3)
    size = _u(buf, off + 4, 4)
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise UnsupportedHDF5(f"fixed-point datatype of {size} bytes")
        order = ">" if bits & 1 else "<"
        return _Datatype(np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
    if cls == 1:  # IEEE float
        if size not in (2, 4, 8):
            raise UnsupportedHDF5(f"floating-point datatype of {size} bytes")
        if bits & 0x40:
            raise UnsupportedHDF5("VAX-order floating-point datatype")
        order = ">" if bits & 1 else "<"
        return _Datatype(np.dtype(f"{order}f{size}"))
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise UnsupportedHDF5("variable-length sequence datatype")
        return _Datatype(None, vlen_str=True)
    name = _CLASS_NAMES.get(cls, f"class {cls}")
    raise UnsupportedHDF5(f"{name} datatype (version {version})")


def _parse_dataspace(buf, off: int) -> Tuple[int, ...]:
    version, rank = buf[off], buf[off + 1]
    if version != 1:
        raise UnsupportedHDF5(f"dataspace message version {version}")
    return tuple(_u(buf, off + 8 + 8 * i, 8) for i in range(rank))


class _Object:
    """The parsed messages of one object header."""

    def __init__(self):
        self.dtype: Optional[_Datatype] = None
        self.shape: Optional[Tuple[int, ...]] = None
        self.fill: Optional[bytes] = None
        self.layout: Optional[tuple] = None
        self.symbol_table: Optional[Tuple[int, int]] = None
        self.attr_msgs: List[bytes] = []


class H5File:
    """One HDF5 file, read on demand.  `file["a/b"]` -> `Group` or
    `Dataset`; `file.attrs` the root's attributes; `close()`."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._read_superblock()
            self.root = Group(self, self._root_addr, "/")
        except BaseException:
            os.close(self._fd)
            raise

    # ----------------------------------------------------------- raw I/O
    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self._fd, n, addr)
        if len(data) != n:
            raise ValueError(f"{self.path}: {n} bytes at {addr:#x} run past the end")
        return data

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- structure
    def _read_superblock(self) -> None:
        head = self.read(0, 8)
        if head != _SIGNATURE:
            raise ValueError(f"{self.path} is not an HDF5 file (the superblock must "
                             "lie at offset 0)")
        sb = self.read(0, 96)
        version = sb[8]
        if version != 0:
            raise UnsupportedHDF5(f"{self.path}: superblock version {version} (a file "
                                  "written with another libver than h5py's default)")
        if sb[13] != 8 or sb[14] != 8:
            raise UnsupportedHDF5(f"{self.path}: {sb[13]}-byte offsets / {sb[14]}-byte "
                                  "lengths (8 and 8 are read)")
        if _u(sb, 24, 8) != 0:
            raise UnsupportedHDF5(f"{self.path}: a base address other than 0")
        # after the base, free-space, end-of-file and driver addresses: the
        # root's symbol table entry (name offset, then object header address)
        self._root_addr = _u(sb, 64, 8)

    def parse_object(self, addr: int) -> _Object:
        """Every message of the version 1 object header at `addr`."""
        prefix = self.read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise UnsupportedHDF5(f"{self.path}: version 2 object header at {addr:#x}")
        if prefix[0] != 1:
            raise UnsupportedHDF5(f"{self.path}: object header version {prefix[0]}")
        n_msgs = _u(prefix, 2, 2)
        blocks = [(addr + 16, _u(prefix, 8, 4))]
        obj = _Object()
        seen = 0
        while blocks and seen < n_msgs:
            start, length = blocks.pop(0)
            buf = self.read(start, length)
            p = 0
            while p + 8 <= length and seen < n_msgs:
                mtype, msize, mflags = _u(buf, p, 2), _u(buf, p + 2, 2), buf[p + 4]
                body = p + 8
                seen += 1
                if mflags & 0x02:
                    raise UnsupportedHDF5(f"{self.path}: shared message of type {mtype:#x}")
                try:
                    self._message(obj, mtype, buf, body, msize, blocks)
                except UnsupportedHDF5 as e:
                    if self.path in str(e):
                        raise
                    raise UnsupportedHDF5(f"{self.path}: object at {addr:#x}: {e}") from None
                p = body + msize
        return obj

    def _message(self, obj: _Object, mtype: int, buf, body: int, msize: int,
                 blocks) -> None:
        if mtype in (0x0, 0x12, 0x16, 0x14):  # NIL, mod time, btree K, bogus
            return
        if mtype == 0x1:
            obj.shape = _parse_dataspace(buf, body)
        elif mtype == 0x3:
            obj.dtype = _parse_datatype(buf, body)
        elif mtype == 0x5:
            obj.fill = _parse_fill(buf, body)
        elif mtype == 0x8:
            obj.layout = _parse_layout(buf, body)
        elif mtype == 0xB:
            raise UnsupportedHDF5(f"{self.path}: filter pipeline ({_filter_names(buf, body)}); "
                                  "only unfiltered datasets are read")
        elif mtype == 0xC:
            obj.attr_msgs.append(bytes(buf[body:body + msize]))
        elif mtype == 0x10:
            blocks.append((_u(buf, body, 8), _u(buf, body + 8, 8)))
        elif mtype == 0x11:
            obj.symbol_table = (_u(buf, body, 8), _u(buf, body + 8, 8))
        elif mtype in (0x2, 0x6, 0xA):
            raise UnsupportedHDF5(f"{self.path}: new-style group storage (link messages "
                                  "or dense fractal-heap link storage)")
        elif mtype == 0x15:
            raise UnsupportedHDF5(f"{self.path}: dense attribute storage")
        # any other message (comments, object reference counts) says
        # nothing this reader needs

    def read_attrs(self, obj: _Object) -> Dict[str, object]:
        return dict(self._attribute(raw) for raw in obj.attr_msgs)

    def _attribute(self, raw: bytes):
        if raw[0] != 1:
            raise UnsupportedHDF5(f"{self.path}: attribute message version {raw[0]}")
        name_size, type_size, space_size = _u(raw, 2, 2), _u(raw, 4, 2), _u(raw, 6, 2)

        def pad(n):  # version 1 pads name, type and space to 8 bytes
            return (n + 7) & ~7

        p = 8
        name = raw[p:p + name_size].split(b"\0", 1)[0].decode("utf-8")
        p += pad(name_size)
        dt = _parse_datatype(raw, p)
        p += pad(type_size)
        shape = _parse_dataspace(raw, p)
        p += pad(space_size)
        n = int(np.prod(shape)) if shape else 1
        if dt.vlen_str:
            vals = [self._vlen_string(raw, p + 16 * i) for i in range(n)]
            return name, vals[0] if not shape else np.array(vals, dtype=object).reshape(shape)
        a = np.frombuffer(raw, dt.dtype, count=n, offset=p).copy()
        return name, a[0] if not shape else a.reshape(shape)

    def _vlen_string(self, raw, p: int) -> str:
        length, coll, index = _u(raw, p, 4), _u(raw, p + 4, 8), _u(raw, p + 12, 4)
        if coll in (0, _UNDEF) or length == 0:
            return ""
        return self._global_heap_object(coll, index)[:length].decode("utf-8")

    def _global_heap_object(self, coll: int, index: int) -> bytes:
        head = self.read(coll, 16)
        if head[:4] != b"GCOL":
            raise ValueError(f"{self.path}: no global heap collection at {coll:#x}")
        size = _u(head, 8, 8)
        buf = self.read(coll, size)
        p = 16
        while p + 16 <= size:
            idx, osize = _u(buf, p, 2), _u(buf, p + 8, 8)
            if idx == 0:
                break
            if idx == index:
                return bytes(buf[p + 16:p + 16 + osize])
            p += 16 + ((osize + 7) & ~7)
        raise ValueError(f"{self.path}: global heap object {index} missing at {coll:#x}")

    def group_links(self, btree: int, heap: int) -> Dict[str, int]:
        """{name: object header address} of a symbol-table group."""
        hh = self.read(heap, 32)
        if hh[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap:#x}")
        data = self.read(_u(hh, 24, 8), _u(hh, 8, 8))
        links: Dict[str, int] = {}
        self._walk_group_btree(btree, data, links)
        return links

    def _walk_group_btree(self, addr: int, heap: bytes, links: Dict[str, int]) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{self.path}: no group B-tree node at {addr:#x}")
        level, used = head[5], _u(head, 6, 2)
        # keys (8 bytes) and children (8 bytes) interleave, key first
        body = self.read(addr + 24, 16 * used + 8)
        children = [_u(body, 8 + 16 * i, 8) for i in range(used)]
        for child in children:
            if level > 0:
                self._walk_group_btree(child, heap, links)
            else:
                self._read_snod(child, heap, links)

    def _read_snod(self, addr: int, heap: bytes, links: Dict[str, int]) -> None:
        head = self.read(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{self.path}: no symbol node at {addr:#x}")
        n = _u(head, 6, 2)
        body = self.read(addr + 8, 40 * n)
        for i in range(n):
            e = 40 * i
            name_off = _u(body, e, 8)
            name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
            links[name] = _u(body, e + 8, 8)

    def chunk_index(self, addr: int, ndims: int) -> List[Tuple[Tuple[int, ...], int, int]]:
        """[(chunk offset, bytes, address)] of a chunked dataset's B-tree
        (node type 1; `ndims` offsets a key, the last the element's)."""
        out: List[Tuple[Tuple[int, ...], int, int]] = []
        self._walk_chunk_btree(addr, ndims, out)
        return out

    def _walk_chunk_btree(self, addr: int, ndims: int, out) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"{self.path}: no chunk B-tree node at {addr:#x}")
        level, used = head[5], _u(head, 6, 2)
        ksize = 8 + 8 * ndims
        body = self.read(addr + 24, used * (ksize + 8) + ksize)
        for i in range(used):
            k = i * (ksize + 8)
            nbytes, mask = _u(body, k, 4), _u(body, k + 4, 4)
            offset = tuple(_u(body, k + 8 + 8 * d, 8) for d in range(ndims - 1))
            child = _u(body, k + ksize, 8)
            if level > 0:
                self._walk_chunk_btree(child, ndims, out)
            else:
                if mask:
                    raise UnsupportedHDF5(f"{self.path}: a chunk with filter mask {mask:#x}")
                out.append((offset, nbytes, child))

    # ------------------------------------------------------------ access
    @property
    def attrs(self) -> Dict[str, object]:
        return self.root.attrs

    def __getitem__(self, path: str):
        return self.root[path]

    def keys(self):
        return self.root.keys()


def _parse_fill(buf, body: int) -> Optional[bytes]:
    """The fill value's bytes, or None when the file defines none."""
    version = buf[body]
    if version != 2:
        raise UnsupportedHDF5(f"fill value message version {version}")
    if not buf[body + 3]:
        return None
    size = _u(buf, body + 4, 4)
    return bytes(buf[body + 8:body + 8 + size]) if size else None


def _parse_layout(buf, body: int) -> tuple:
    version, cls = buf[body], buf[body + 1]
    if version != 3:
        raise UnsupportedHDF5(f"data layout message version {version}")
    p = body + 2
    if cls == 0:
        size = _u(buf, p, 2)
        return ("compact", bytes(buf[p + 2:p + 2 + size]))
    if cls == 1:
        return ("contiguous", _u(buf, p, 8), _u(buf, p + 8, 8))
    if cls == 2:
        ndims = buf[p]
        addr = _u(buf, p + 1, 8)
        dims = tuple(_u(buf, p + 9 + 4 * i, 4) for i in range(ndims))
        return ("chunked", addr, dims)
    raise UnsupportedHDF5(f"data layout class {cls} (virtual)")


def _filter_names(buf, body: int) -> str:
    version, n = buf[body], buf[body + 1]
    p = body + (8 if version == 1 else 2)
    names = []
    for _ in range(n):
        fid = _u(buf, p, 2)
        names.append(_FILTERS.get(fid, f"filter {fid}"))
        if version == 1 or fid >= 256:
            name_len, n_vals = _u(buf, p + 2, 2), _u(buf, p + 6, 2)
            p += 8 + name_len + 4 * n_vals
            if version == 1 and n_vals % 2:
                p += 4
        else:
            n_vals = _u(buf, p + 4, 2)
            p += 6 + 4 * n_vals
    return ", ".join(names)


class Group:
    """A symbol-table group: `keys()`, `items()`, `g[name]`, `attrs`."""

    def __init__(self, file: H5File, addr: int, name: str, obj: Optional[_Object] = None):
        self.file, self.addr, self.name = file, addr, name
        self._obj = obj or file.parse_object(addr)
        if self._obj.symbol_table is None:
            raise ValueError(f"{file.path}: {name} is not a group")
        self._links: Optional[Dict[str, int]] = None

    @property
    def links(self) -> Dict[str, int]:
        if self._links is None:
            self._links = self.file.group_links(*self._obj.symbol_table)
        return self._links

    @property
    def attrs(self) -> Dict[str, object]:
        return self.file.read_attrs(self._obj)

    def keys(self) -> List[str]:
        return sorted(self.links)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __getitem__(self, path: str):
        head, _, rest = path.strip("/").partition("/")
        if head not in self.links:
            raise KeyError(f"{self.file.path}: no object {head!r} in {self.name}")
        addr = self.links[head]
        obj = self.file.parse_object(addr)
        name = self.name.rstrip("/") + "/" + head
        node = (Group(self.file, addr, name, obj) if obj.symbol_table is not None
                else Dataset(self.file, name, obj))
        return node[rest] if rest else node


class Dataset:
    """A dataset: `shape`, `dtype`, `read()`."""

    def __init__(self, file: H5File, name: str, obj: _Object):
        if obj.dtype is None or obj.shape is None or obj.layout is None:
            raise ValueError(f"{file.path}: {name} is neither a group nor a dataset")
        if obj.dtype.vlen_str:
            raise UnsupportedHDF5(f"{file.path}: {name} is a dataset of variable-length "
                                  "strings")
        self.file, self.name, self._obj = file, name, obj
        self.shape, self.dtype = obj.shape, obj.dtype.dtype

    def _filled(self) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        fill = self._obj.fill
        if fill and len(fill) == self.dtype.itemsize:
            out[...] = np.frombuffer(fill, self.dtype)[0]
        else:
            out.view(np.uint8)[...] = 0
        return out

    def read(self) -> np.ndarray:
        n = int(np.prod(self.shape)) if self.shape else 1
        nbytes = n * self.dtype.itemsize
        layout = self._obj.layout
        if layout[0] == "compact":
            return np.frombuffer(layout[1], self.dtype, count=n).reshape(self.shape).copy()
        if layout[0] == "contiguous":
            _, addr, size = layout
            if addr == _UNDEF or nbytes == 0:
                return self._filled()
            return np.frombuffer(self.file.read(addr, nbytes), self.dtype
                                 ).reshape(self.shape).copy()
        _, btree, dims = layout
        chunk = dims[:-1]
        out = self._filled()
        if btree == _UNDEF or n == 0:
            return out
        cbytes = int(np.prod(chunk)) * self.dtype.itemsize
        for offset, size, addr in self.file.chunk_index(btree, len(dims)):
            if size != cbytes:
                raise ValueError(f"{self.file.path}: {self.name}: a chunk of {size} "
                                 f"bytes, {cbytes} expected")
            block = np.frombuffer(self.file.read(addr, size), self.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self.shape))
            out[dst] = block[tuple(slice(0, sl.stop - sl.start) for sl in dst)]
        return out


# ------------------------------------------------------------------ writer
_LEAF_K, _NODE_K = 4, 16           # h5py's defaults: <= 8 names a SNOD, <= 32 children a node
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
_HEAP_FREE_NULL = 1                # a local heap's "no free block"
_GCOL_MIN = 4096                   # the smallest global heap collection HDF5 reads


def _p64(*vals) -> bytes:
    return b"".join(int(v).to_bytes(8, "little") for v in vals)


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _encode_datatype(dtype: np.dtype) -> bytes:
    """A datatype message body (unpadded) for a numeric numpy dtype."""
    dtype = np.dtype(dtype)
    big = dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian)
    n = dtype.itemsize
    if dtype.kind in "iu" and n in (1, 2, 4, 8):
        bits = int(big) | (0x08 if dtype.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + n.to_bytes(4, "little")
                + (0).to_bytes(2, "little") + (8 * n).to_bytes(2, "little"))
    if dtype.kind == "f" and n in (2, 4, 8):
        exp_loc, exp_size, mant, bias = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                                         8: (52, 11, 52, 1023)}[n]
        return (bytes([0x11, 0x20 | int(big), 8 * n - 1, 0]) + n.to_bytes(4, "little")
                + (0).to_bytes(2, "little") + (8 * n).to_bytes(2, "little")
                + bytes([exp_loc, exp_size, 0, mant]) + bias.to_bytes(4, "little"))
    raise UnsupportedHDF5(f"writing a {dtype} array (fixed-point and IEEE float types of "
                          "1-8 bytes are written; h5py stores bool as an enum, which the "
                          "reader refuses)")


_VLEN_STR = (bytes([0x19, 0x01, 0x01, 0x00]) + (16).to_bytes(4, "little")   # UTF-8, null-term
             + bytes([0x10, 0, 0, 0]) + (1).to_bytes(4, "little")           # base: 1-byte uint
             + (0).to_bytes(2, "little") + (8).to_bytes(2, "little"))


def _encode_dataspace(shape) -> bytes:
    """Version 1 dataspace with its maximum dims equal to its dims (a
    scalar: rank 0)."""
    flags = 1 if shape else 0
    return bytes([1, len(shape), flags, 0, 0, 0, 0, 0]) + _p64(*shape) + (
        _p64(*shape) if shape else b"")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return (mtype.to_bytes(2, "little") + len(body).to_bytes(2, "little")
            + bytes([flags, 0, 0, 0]) + body)


class _Writer:
    """Appends the objects of one file to a buffer; addresses are offsets
    into it (the superblock's 96 bytes come first, filled in last)."""

    def __init__(self):
        self.buf = bytearray(96)

    def put(self, data: bytes) -> int:
        self.buf += bytes(-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += data
        return addr

    def header(self, messages) -> int:
        body = b"".join(messages)
        prefix = (bytes([1, 0]) + len(messages).to_bytes(2, "little")
                  + (1).to_bytes(4, "little") + len(body).to_bytes(4, "little") + bytes(4))
        return self.put(prefix + body)

    def dataset(self, a: np.ndarray) -> int:
        a = np.ascontiguousarray(a)
        dtype = _encode_datatype(a.dtype)
        if a.size:
            layout = bytes([3, 1]) + _p64(self.put(a.tobytes()), a.nbytes)
        else:  # never written: the address stays undefined, as h5py leaves it
            layout = bytes([3, 1]) + _p64(_UNDEF, 0)
        return self.header([_message(0x1, _encode_dataspace(a.shape), 1),
                            _message(0x3, dtype, 1),
                            _message(0x5, bytes([2, 2, 2, 1, 0, 0, 0, 0]), 1),
                            _message(0x8, layout)])

    def attribute(self, name: str, value) -> bytes:
        if isinstance(value, str):
            data = value.encode("utf-8")
            coll = self.gcol(data)
            dtype, space = _VLEN_STR, _encode_dataspace(())
            raw = len(data).to_bytes(4, "little") + _p64(coll) + (1).to_bytes(4, "little")
        else:
            a = np.asarray(value)
            dtype, space, raw = _encode_datatype(a.dtype), _encode_dataspace(a.shape), \
                np.ascontiguousarray(a).tobytes()
        nm = name.encode("utf-8") + b"\0"
        body = (bytes([1, 0]) + len(nm).to_bytes(2, "little") + len(dtype).to_bytes(2, "little")
                + len(space).to_bytes(2, "little") + _pad8(nm) + _pad8(dtype) + _pad8(space)
                + raw)
        return _message(0xC, body)

    def gcol(self, data: bytes) -> int:
        """A global heap collection holding `data` as object 1."""
        obj = (1).to_bytes(2, "little") + bytes(6) + _p64(len(data)) + _pad8(data)
        size = max(_GCOL_MIN, 16 + len(obj) + 16)
        free = (0).to_bytes(2, "little") + bytes(6) + _p64(size - 16 - len(obj))
        out = b"GCOL" + bytes([1, 0, 0, 0]) + _p64(size) + obj + free
        return self.put(out + bytes(size - len(out)))

    def group(self, tree: dict, attrs=None):
        """Write `tree` ({name: array or dict}) as a group.  -> (object
        header address, B-tree address, local heap address)."""
        entries = []  # (name bytes, header address, (btree, heap) or None)
        for name, node in tree.items():
            if isinstance(node, dict):
                addr, btree, heap = self.group(node)
                entries.append((name.encode("utf-8"), addr, (btree, heap)))
            else:
                entries.append((name.encode("utf-8"), self.dataset(np.asarray(node)), None))
        entries.sort(key=lambda e: e[0])  # the B-tree's order: strcmp on the names
        heap_data, offsets = bytearray(8), []  # offset 0: the empty name
        for name, _, _ in entries:
            offsets.append(len(heap_data))
            heap_data += _pad8(name + b"\0")
        heap = self.put(b"HEAP" + bytes(4) + _p64(len(heap_data), _HEAP_FREE_NULL, 0))
        data_addr = self.put(bytes(heap_data))
        self.buf[heap + 24:heap + 32] = _p64(data_addr)
        # symbol nodes of at most 2 * leaf K names each, then B-tree levels
        n_snod = max(1, -(-len(entries) // (2 * _LEAF_K)))
        children = []  # (address, heap offset of the subtree's last name)
        for chunk in np.array_split(np.arange(len(entries)), n_snod):
            node = bytearray(b"SNOD" + bytes([1, 0]) + len(chunk).to_bytes(2, "little"))
            for i in chunk:
                name, addr, scratch = entries[i]
                node += _p64(offsets[i], addr) + (
                    (1).to_bytes(4, "little") + bytes(4) + _p64(*scratch) if scratch
                    else bytes(24))
            node += bytes(_SNOD_SIZE - len(node))
            children.append((self.put(bytes(node)), offsets[chunk[-1]] if len(chunk) else 0))
        level = 0
        while True:
            n_node = max(1, -(-len(children) // (2 * _NODE_K)))
            parents = []
            for chunk in np.array_split(np.arange(len(children)), n_node):
                node = bytearray(b"TREE" + bytes([0, level]) + len(chunk).to_bytes(2, "little")
                                 + _p64(_UNDEF, _UNDEF) + _p64(0))
                for i in chunk:
                    node += _p64(children[i][0], children[i][1])
                node += bytes(_TREE_SIZE - len(node))
                parents.append((self.put(bytes(node)), children[chunk[-1]][1]))
            if len(parents) == 1:
                btree = parents[0][0]
                break
            children, level = parents, level + 1
        messages = [_message(0x11, _p64(btree, heap))]
        messages += [self.attribute(k, v) for k, v in (attrs or {}).items()]
        return self.header(messages), btree, heap

    def finish(self, root) -> bytes:
        addr, btree, heap = root
        self.buf[:96] = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                         + _LEAF_K.to_bytes(2, "little") + _NODE_K.to_bytes(2, "little")
                         + bytes(4) + _p64(0, _UNDEF, len(self.buf), _UNDEF)
                         + _p64(0, addr) + (1).to_bytes(4, "little") + bytes(4)
                         + _p64(btree, heap))
        return bytes(self.buf)


def write_h5(path: str, tree: dict, attrs: Optional[dict] = None) -> None:
    """Write `tree` ({name: array, or a dict for a sub-group}) to `path` as
    an HDF5 file of the subset above, with `attrs` ({name: number, numeric
    array or str}) on its root group.  The file appears whole or not at all
    (written beside `path`, then renamed)."""
    w = _Writer()
    data = w.finish(w.group(tree, attrs))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
