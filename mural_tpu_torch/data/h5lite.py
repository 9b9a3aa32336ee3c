"""A reader and writer for the subset of HDF5 that the site-table cache
uses (:mod:`mural_tpu_torch.data.cache`), in numpy, ``struct`` and
``zlib``; the JAX package reads and writes the same files with h5py.

Reading covers what h5py writes by default (``libver="earliest"``):

- superblock version 0, any group leaf and internal K;
- groups as a v1 B-tree (node type 0) of any depth over symbol-table
  nodes (``SNOD``), names in the local heap;
- version 1 object headers, continuation messages followed and unknown
  messages skipped;
- dataspace messages version 1 and 2;
- little-endian fixed-point and floating-point types, fixed-length
  strings, enums (read as their base type, or as bool when the members
  are exactly ``FALSE=0, TRUE=1``, as h5py does) and variable-length
  strings (global-heap ``GCOL`` collections);
- data layout version 3: compact, contiguous and chunked, the chunk
  v1 B-tree (node type 1) of any depth, edge chunks cut to the shape;
- a filter pipeline version 1 of deflate only;
- attribute messages version 1 to 3.

Anything else raises :class:`UnsupportedFeature`, an :class:`OSError`
that names the feature, and a damaged file raises :class:`FormatError`
(also an :class:`OSError`): the cache then treats the file as stale, as
the JAX package does when h5py raises.

Writing gives files that h5py reads back with the same dtypes: a v0
superblock, a root group whose symbol-table nodes hold the entries sorted
by name under correct B-tree keys, each non-empty dataset as one chunk
deflated at level 1 (a chunk may not exceed 4 GiB), bool as h5py's int8
enum and string attributes as fixed-length byte strings.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["read", "write", "FormatError", "UnsupportedFeature"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"


class FormatError(OSError):
    """The file is not HDF5, or is damaged."""


class UnsupportedFeature(OSError):
    """The file uses a part of HDF5 outside this module's subset."""

    def __init__(self, feature: str):
        super().__init__(f"HDF5 feature not supported: {feature}")
        self.feature = feature


# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0, 0x1, 0x2, 0x3
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_CLASS_NAMES = {2: "time datatype", 4: "bitfield datatype",
                5: "opaque datatype", 6: "compound datatype",
                7: "reference datatype", 10: "array datatype"}
_FILTER_NAMES = {2: "shuffle filter", 3: "fletcher32 filter",
                 4: "szip filter", 5: "nbit filter",
                 6: "scaleoffset filter"}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _VlenString:
    """A variable-length string type (element: length, collection
    address, object index)."""

    def __init__(self, utf8: bool, itemsize: int):
        self.utf8 = utf8
        self.itemsize = itemsize


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        if buf[:8] != SIGNATURE:
            raise FormatError("no HDF5 signature")
        if buf[8] != 0:
            raise UnsupportedFeature(f"superblock version {buf[8]}")
        self.so, self.sl = buf[13], buf[14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise FormatError("bad sizes of offsets and lengths")
        self.undef = (1 << (8 * self.so)) - 1
        self.base = self.addr(24)
        # four addresses (the base first), then the root group's symbol
        # table entry
        self.root = self.addr(24 + 5 * self.so)

    def addr(self, p: int) -> int:
        return int.from_bytes(self.buf[p:p + self.so], "little")

    def length(self, p: int) -> int:
        return int.from_bytes(self.buf[p:p + self.sl], "little")

    def cstr_end(self, p: int) -> int:
        """Position of the null that ends the string at ``p``."""
        end = self.buf.find(b"\0", p)
        if end < 0:
            raise FormatError("unterminated string")
        return end

    def at(self, a: int) -> int:
        """File position of address ``a``."""
        if a == self.undef:
            raise FormatError("undefined address")
        return self.base + a

    # object headers -------------------------------------------------
    def messages(self, a: int):
        """[(type, flags, start, size)] of a v1 object header."""
        p = self.at(a)
        if self.buf[p:p + 4] == b"OHDR":
            raise UnsupportedFeature("object header version 2")
        version, n_msgs = self.buf[p], struct.unpack_from("<H", self.buf,
                                                          p + 2)[0]
        if version != 1:
            raise UnsupportedFeature(f"object header version {version}")
        size = struct.unpack_from("<I", self.buf, p + 8)[0]
        blocks = [(p + 16, size)]
        out = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 8 <= end and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", self.buf, q)
                q += 8
                if q + msize > end:
                    raise FormatError("object header message overruns "
                                      "its block")
                if mtype == _CONTINUATION:
                    blocks.append((self.at(self.addr(q)),
                                   self.length(q + self.so)))
                out.append((mtype, flags, q, msize))
                q += msize
        return out

    # datatypes, dataspaces --------------------------------------------
    def datatype(self, p: int):
        """(numpy dtype or _VlenString, encoded size) at ``p``."""
        cls_ver = self.buf[p]
        cls, version = cls_ver & 0x0F, cls_ver >> 4
        bits = self.buf[p + 1] | (self.buf[p + 2] << 8) | (
            self.buf[p + 3] << 16)
        size = struct.unpack_from("<I", self.buf, p + 4)[0]
        if version not in (1, 2, 3):
            raise UnsupportedFeature(f"datatype version {version}")
        q = p + 8
        if cls in (0, 1):
            if bits & 1 or (cls == 1 and bits & 0x40):
                raise UnsupportedFeature("big-endian or VAX byte order")
            offset, precision = struct.unpack_from("<HH", self.buf, q)
            if offset != 0 or precision != 8 * size:
                raise UnsupportedFeature("padded numeric type")
            if cls == 0:
                if size not in (1, 2, 4, 8):
                    raise UnsupportedFeature(f"{size}-byte integer")
                kind = "i" if bits & 0x08 else "u"
                return np.dtype(f"<{kind}{size}"), 12
            if size not in (2, 4, 8):
                raise UnsupportedFeature(f"{size}-byte float")
            return np.dtype(f"<f{size}"), 20
        if cls == 3:
            return np.dtype(f"S{size}"), 8
        if cls == 8:
            base, used = self.datatype(q)
            if not isinstance(base, np.dtype) or base.kind not in "iu":
                raise UnsupportedFeature("enum over a non-integer type")
            q += used
            names = []
            for _ in range(bits & 0xFFFF):
                end = self.cstr_end(q)
                names.append(bytes(self.buf[q:end]))
                q = (q + _pad8(end - q + 1) if version < 3 else end + 1)
            values = np.frombuffer(
                self.buf[q:q + base.itemsize * len(names)], base)
            q += base.itemsize * len(names)
            if dict(zip(names, values.tolist())) == {b"FALSE": 0,
                                                     b"TRUE": 1}:
                return np.dtype(bool), q - p
            return base, q - p
        if cls == 9:
            if bits & 0x0F != 1:
                raise UnsupportedFeature("variable-length sequence")
            _, used = self.datatype(q)
            return _VlenString((bits >> 8) & 0x0F == 1, size), 8 + used
        raise UnsupportedFeature(_CLASS_NAMES.get(cls, f"datatype class "
                                                  f"{cls}"))

    def dataspace(self, p: int) -> Tuple[int, ...]:
        version, rank = self.buf[p], self.buf[p + 1]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:            # null dataspace
                return (0,)
            q = p + 4
        else:
            raise UnsupportedFeature(f"dataspace version {version}")
        return tuple(self.length(q + i * self.sl) for i in range(rank))

    # values ---------------------------------------------------------
    def vlen_strings(self, raw: bytes, kind: _VlenString, n: int):
        out = []
        for i in range(n):
            p = i * kind.itemsize
            size = struct.unpack_from("<I", raw, p)[0]
            coll = int.from_bytes(raw[p + 4:p + 4 + self.so], "little")
            index = struct.unpack_from("<I", raw, p + 4 + self.so)[0]
            data = (self.heap_object(coll, index)[:size] if size else b"")
            out.append(data.decode("utf-8" if kind.utf8 else "ascii"))
        return out

    def heap_object(self, coll: int, index: int) -> bytes:
        p = self.at(coll)
        if self.buf[p:p + 4] != b"GCOL":
            raise FormatError("bad global heap collection")
        end = p + self.length(p + 8)
        q = p + 8 + self.sl
        while q + 8 + self.sl <= end:
            idx = struct.unpack_from("<H", self.buf, q)[0]
            size = self.length(q + 8)
            if idx == 0:
                break
            if idx == index:
                return bytes(self.buf[q + 8 + self.sl:q + 8 + self.sl
                                      + size])
            q += 8 + self.sl + _pad8(size)
        raise FormatError(f"global heap object {index} not found")

    def value(self, raw, dtype, shape):
        n = int(np.prod(shape, dtype=np.int64))
        if isinstance(dtype, _VlenString):
            vals = self.vlen_strings(raw, dtype, n)
            if shape == ():
                return vals[0]
            return np.array(vals, dtype=object).reshape(shape)
        if dtype == np.dtype(bool):
            arr = np.frombuffer(raw, np.int8, n).astype(bool)
        else:
            arr = np.frombuffer(raw, dtype, n).copy()
        arr = arr.reshape(shape)
        return arr[()] if shape == () else arr

    # attributes -----------------------------------------------------
    def attribute(self, p: int, size: int):
        version = self.buf[p]
        if version not in (1, 2, 3):
            raise UnsupportedFeature(f"attribute message version {version}")
        if version > 1 and self.buf[p + 1] & 0x03:
            raise UnsupportedFeature("shared attribute datatype/dataspace")
        n_name, n_type, n_space = struct.unpack_from("<HHH", self.buf, p + 2)
        q = p + 8 + (1 if version == 3 else 0)
        align = _pad8 if version == 1 else (lambda n: n)
        name = bytes(self.buf[q:q + n_name]).split(b"\0", 1)[0].decode()
        q += align(n_name)
        dtype, _ = self.datatype(q)
        q += align(n_type)
        shape = self.dataspace(q)
        q += align(n_space)
        itemsize = dtype.itemsize
        n = int(np.prod(shape, dtype=np.int64))
        raw = bytes(self.buf[q:q + n * itemsize])
        if len(raw) != n * itemsize or q + n * itemsize > p + size:
            raise FormatError(f"attribute {name!r} is truncated")
        return name, self.value(raw, dtype, shape)

    # groups ---------------------------------------------------------
    def group(self, a: int):
        """(attributes, {name: object header address}) of a group."""
        attrs, stab = {}, None
        for mtype, flags, q, size in self.messages(a):
            if mtype == _SYMBOL_TABLE:
                stab = (self.addr(q), self.addr(q + self.so))
            elif mtype == _ATTRIBUTE:
                name, val = self.attribute(q, size)
                attrs[name] = val
            elif mtype == _ATTRIBUTE_INFO:
                # fractal heap address after version, flags and the
                # optional maximum creation index
                heap = self.addr(q + 2 + (2 if self.buf[q + 1] & 1 else 0))
                if heap != self.undef:
                    raise UnsupportedFeature("dense attribute storage")
            elif mtype in (_LINK, _LINK_INFO):
                raise UnsupportedFeature("link messages (new-style group)")
        if stab is None:
            raise FormatError("group without a symbol table")
        btree, heap = stab
        p = self.at(heap)
        if self.buf[p:p + 4] != b"HEAP":
            raise FormatError("bad local heap")
        names_at = self.at(self.addr(p + 8 + 2 * self.sl))
        members = {}
        for snod in self.btree_children(btree, 0):
            s = self.at(snod)
            if self.buf[s:s + 4] != b"SNOD":
                raise FormatError("bad symbol table node")
            n = struct.unpack_from("<H", self.buf, s + 6)[0]
            esize = 2 * self.so + 24
            for i in range(n):
                e = s + 8 + i * esize
                off = names_at + self.length(e)
                name = bytes(self.buf[off:self.cstr_end(off)])
                members[name.decode()] = self.addr(e + self.so)
        return attrs, members

    def btree_children(self, a: int, node_type: int, ndims: int = 0):
        """Leaf entries of a v1 B-tree: SNOD addresses (type 0), or
        (chunk address, size, filter mask, offsets) (type 1)."""
        key = self.sl if node_type == 0 else 8 + 8 * ndims
        stack, out = [a], []
        while stack:
            p = self.at(stack.pop())
            if self.buf[p:p + 4] != b"TREE" or self.buf[p + 4] != node_type:
                raise FormatError("bad B-tree node")
            level = self.buf[p + 5]
            n = struct.unpack_from("<H", self.buf, p + 6)[0]
            q = p + 8 + 2 * self.so
            entries = []
            for i in range(n):
                k = q + i * (key + self.so)
                child = self.addr(k + key)
                if level > 0:
                    entries.append(child)
                elif node_type == 0:
                    out.append(child)
                else:
                    size, mask = struct.unpack_from("<II", self.buf, k)
                    offs = struct.unpack_from(f"<{ndims}Q", self.buf, k + 8)
                    out.append((child, size, mask, offs[:-1]))
            stack.extend(reversed(entries))
        return out

    # datasets -------------------------------------------------------
    def dataset(self, a: int, read_data: bool):
        dtype = shape = layout = None
        filters = []
        for mtype, flags, q, size in self.messages(a):
            if mtype in (_DATATYPE, _DATASPACE) and flags & 0x02:
                raise UnsupportedFeature("shared datatype or dataspace")
            if mtype == _DATATYPE:
                dtype, _ = self.datatype(q)
            elif mtype == _DATASPACE:
                shape = self.dataspace(q)
            elif mtype == _LAYOUT:
                layout = q
            elif mtype == _FILTERS:
                filters = self.filters(q)
        if dtype is None or shape is None or layout is None:
            raise FormatError("dataset header lacks a type, space or layout")
        if isinstance(dtype, _VlenString):
            raise UnsupportedFeature("variable-length string dataset")
        if not read_data:
            return None
        return self.layout_data(layout, dtype, shape, filters)

    def filters(self, q: int):
        version, n = self.buf[q], self.buf[q + 1]
        if version != 1:
            raise UnsupportedFeature(f"filter pipeline version {version}")
        q += 8
        ids = []
        for _ in range(n):
            fid, n_name, _flags, n_vals = struct.unpack_from(
                "<HHHH", self.buf, q)
            if fid != 1:
                raise UnsupportedFeature(_FILTER_NAMES.get(
                    fid, f"filter {fid}"))
            ids.append(fid)
            q += 8 + _pad8(n_name) + 4 * n_vals + (4 if n_vals % 2 else 0)
        return ids

    def layout_data(self, q: int, dtype, shape, filters):
        version, cls = self.buf[q], self.buf[q + 1]
        if version != 3:
            raise UnsupportedFeature(f"data layout version {version}")
        item = dtype.itemsize
        store = np.int8 if dtype == np.dtype(bool) else dtype
        n = int(np.prod(shape, dtype=np.int64))
        if cls == 0:                            # compact
            size = struct.unpack_from("<H", self.buf, q + 2)[0]
            raw = bytes(self.buf[q + 4:q + 4 + size])
            out = np.frombuffer(raw, store, n).reshape(shape).copy()
        elif cls == 1:                          # contiguous
            a = self.addr(q + 2)
            if a == self.undef:
                out = np.zeros(shape, store)
            else:
                p = self.at(a)
                raw = self.buf[p:p + n * item]
                if len(raw) != n * item:
                    raise FormatError("contiguous data is truncated")
                out = np.frombuffer(raw, store, n).reshape(shape).copy()
        elif cls == 2:                          # chunked
            ndims = self.buf[q + 2]
            btree = self.addr(q + 3)
            chunk = struct.unpack_from(f"<{ndims}I", self.buf,
                                       q + 3 + self.so)[:-1]
            out = np.zeros(shape, store)
            if btree != self.undef:
                for a, size, mask, offs in self.btree_children(btree, 1,
                                                               ndims):
                    p = self.at(a)
                    raw = self.buf[p:p + size]
                    # undo the pipeline's filters (all deflate), last
                    # first, but those the chunk's mask skipped
                    for i in reversed(range(len(filters))):
                        if not mask >> i & 1:
                            raw = zlib.decompress(raw)
                    block = np.frombuffer(raw, store,
                                          int(np.prod(chunk))
                                          ).reshape(chunk)
                    dst = tuple(slice(o, min(o + c, s))
                                for o, c, s in zip(offs, chunk, shape))
                    out[dst] = block[tuple(slice(0, d.stop - d.start)
                                           for d in dst)]
        else:
            raise UnsupportedFeature(f"data layout class {cls}")
        if dtype == np.dtype(bool):
            return out.astype(bool)
        return out


def read(path: str, names: Optional[Iterable[str]] = None):
    """``(attrs, datasets)`` of the root group of the HDF5 file at
    ``path``.  ``datasets`` has an entry for every dataset of the root
    group: its array when ``names`` is None or holds its name, else None
    (``read(path, names=())`` lists the datasets without reading them)."""
    import mmap
    wanted = None if names is None else set(names)
    with open(path, "rb") as fh:
        try:
            buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:                 # an empty file
            raise FormatError(f"{path}: {e}") from None
    try:
        r = _Reader(buf)
        attrs, members = r.group(r.root)
        datasets = {}
        for name, a in members.items():
            datasets[name] = r.dataset(a, wanted is None or name in wanted)
        return attrs, datasets
    except (struct.error, IndexError, ValueError, zlib.error) as e:
        raise FormatError(f"{path}: damaged HDF5 file ({e})") from None
    finally:
        buf.close()


# ---------------------------------------------------------------- writing

_SO = 8                         # size of offsets and lengths written
_UNDEF = (1 << 64) - 1
_LEAF_K, _INTERNAL_K, _CHUNK_K = 4, 16, 32
_MAX_CHUNK = (1 << 32) - 1


def _enc_datatype(dtype: np.dtype) -> bytes:
    if dtype == np.dtype(bool):                 # h5py's enum over int8
        base = _enc_datatype(np.dtype(np.int8))
        names = b"".join(n + b"\0" * (_pad8(len(n) + 1) - len(n))
                         for n in (b"FALSE", b"TRUE"))
        return (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names
                + b"\x00\x01")
    if dtype.byteorder == ">":
        raise UnsupportedFeature("big-endian type")
    if dtype.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dtype.kind == "i"
                           else 0, 0, 0, dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in (4, 8):
        exp, mant, bias = ((8, 23, 127) if dtype.itemsize == 4
                           else (11, 52, 1023))
        bits = 8 * dtype.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, bits - 1, 0,
                           dtype.itemsize, 0, bits, mant, exp, 0, mant,
                           bias)
    if dtype.kind == "S":
        # null-padded ASCII, as h5py writes numpy byte strings
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0,
                           max(1, dtype.itemsize))
    raise UnsupportedFeature(f"writing numpy dtype {dtype}")


def _enc_dataspace(shape) -> bytes:
    return (struct.pack("<BBBBI", 1, len(shape), 0, 0, 0)
            + b"".join(struct.pack("<Q", d) for d in shape))


def _message(mtype: int, body: bytes) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    if len(body) > 0xFFFF:
        raise UnsupportedFeature("object header message above 64 KiB")
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _attribute(name: str, value) -> bytes:
    if isinstance(value, str):
        value = value.encode()
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
        arr = arr.astype("S1")
    arr = np.asarray(arr, order="C")
    if arr.dtype.byteorder == ">":
        raise UnsupportedFeature("big-endian type")
    raw_name = name.encode() + b"\0"
    dt, ds = _enc_datatype(arr.dtype), _enc_dataspace(arr.shape)
    data = (arr.astype(np.int8) if arr.dtype == bool else arr).tobytes()

    def padded(b):
        return b + b"\0" * (_pad8(len(b)) - len(b))
    return _message(_ATTRIBUTE, struct.pack(
        "<BBHHH", 1, 0, len(raw_name), len(dt), len(ds))
        + padded(raw_name) + padded(dt) + padded(ds) + data)


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self):
        self.parts = []
        self.size = 0

    def alloc(self, n: int) -> int:
        a = self.size
        self.size += _pad8(n)
        return a

    def put(self, data: bytes) -> int:
        a = self.alloc(len(data))
        self.parts.append((a, data))
        return a


def _dataset(w: _Writer, arr: np.ndarray) -> int:
    arr = np.asarray(arr, order="C")
    if arr.dtype.kind not in "biuf":
        raise UnsupportedFeature(f"dataset of numpy dtype {arr.dtype}")
    if arr.dtype.byteorder == ">":
        raise UnsupportedFeature("big-endian type")
    raw = (arr.astype(np.int8) if arr.dtype == bool else arr).tobytes()
    item = arr.dtype.itemsize
    msgs = [_message(_DATASPACE, _enc_dataspace(arr.shape)),
            _message(_DATATYPE, _enc_datatype(arr.dtype))]
    if arr.ndim == 0 or arr.size == 0:
        # contiguous; an empty dataset has no storage
        a = w.put(raw) if raw else _UNDEF
        msgs.append(_message(_LAYOUT, struct.pack("<BBQQ", 3, 1, a,
                                                  len(raw))))
        header = _object_header(msgs)
        return w.put(header)
    if len(raw) > _MAX_CHUNK or max(arr.shape) > _MAX_CHUNK:
        raise UnsupportedFeature("a chunk above 4 GiB")
    data = zlib.compress(raw, 1)
    ndims = arr.ndim + 1
    node_size = (24 + (2 * _CHUNK_K + 1) * (8 + 8 * ndims)
                 + 2 * _CHUNK_K * _SO)
    node_at = w.alloc(node_size)
    data_at = w.put(data)
    # one leaf entry; the right key is the chunk's scaled offset plus
    # one in every dimension, as the HDF5 library writes it
    node = (b"TREE" + struct.pack("<BBHQQ", 1, 0, 1, _UNDEF, _UNDEF)
            + struct.pack(f"<II{ndims}Q", len(data), 0, *([0] * ndims))
            + struct.pack("<Q", data_at)
            + struct.pack(f"<II{ndims}Q", 0, 0, *arr.shape, item))
    w.parts.append((node_at, node + b"\0" * (node_size - len(node))))
    msgs.append(_message(_LAYOUT, struct.pack(
        f"<BBBQ{ndims}I", 3, 2, ndims, node_at, *arr.shape, item)))
    # deflate (filter 1, "deflate", one client value: the level)
    msgs.append(_message(_FILTERS, struct.pack("<BB6x", 1, 1)
                         + struct.pack("<HHHH", 1, 8, 0, 1) + b"deflate\0"
                         + struct.pack("<I4x", 1)))
    return w.put(_object_header(msgs))


def write(path: str, attrs: Dict[str, object],
          datasets: Dict[str, np.ndarray]) -> None:
    """Write ``datasets`` (numeric or bool arrays) and ``attrs`` (ints,
    floats, strings and numeric or byte-string arrays) as the root group
    of a new HDF5 file at ``path``.  The file is written under a name
    unique to this process and thread, then renamed over ``path``, so
    concurrent writers of one path each leave a complete file."""
    w = _Writer()
    w.alloc(96)                                 # superblock
    root_msgs = [_attribute(k, v) for k, v in attrs.items()]
    names = sorted(datasets)
    # local heap: "" at offset 0, then each name
    heap_data, offsets = bytearray(8), {}
    for name in names:
        raw = name.encode()
        if b"\0" in raw or b"/" in raw or not raw:
            raise ValueError(f"bad dataset name {name!r}")
        offsets[name] = len(heap_data)
        heap_data += raw + b"\0" * (_pad8(len(raw) + 1) - len(raw))
    snods = [names[i:i + 2 * _LEAF_K]
             for i in range(0, len(names), 2 * _LEAF_K)]
    if len(snods) > 2 * _INTERNAL_K:
        raise UnsupportedFeature(f"more than {2 * _INTERNAL_K * 2 * _LEAF_K}"
                                 " datasets in one group")
    header_at = {name: _dataset(w, datasets[name]) for name in names}
    heap_at = w.alloc(32)
    data_at = w.put(bytes(heap_data))
    w.parts.append((heap_at, b"HEAP" + struct.pack(
        "<B3xQQQ", 0, len(heap_data), 1, data_at)))
    entry = 2 * _SO + 24
    snod_at = []
    for group in snods:
        body = b"SNOD" + struct.pack("<BBH", 1, 0, len(group)) + b"".join(
            struct.pack("<QQII16x", offsets[n], header_at[n], 0, 0)
            for n in group)
        snod_at.append(w.put(body + b"\0" * (8 + 2 * _LEAF_K * entry
                                             - len(body))))
    # group B-tree: key 0 is "", key i+1 the last name of node i
    keys = [0] + [offsets[g[-1]] for g in snods]
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), _UNDEF, _UNDEF)
    for key, child in zip(keys, snod_at):
        node += struct.pack("<QQ", key, child)
    node += struct.pack("<Q", keys[-1])
    node_size = 24 + (2 * _INTERNAL_K + 1) * _SO + 2 * _INTERNAL_K * _SO
    btree_at = w.put(node + b"\0" * (node_size - len(node)))
    root_at = w.put(_object_header(
        [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))]
        + root_msgs))
    eof = w.size
    superblock = (SIGNATURE + struct.pack(
        "<BBBBBBBBHHI", 0, 0, 0, 0, 0, _SO, _SO, 0, _LEAF_K, _INTERNAL_K, 0)
        + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        + struct.pack("<QQII", 0, root_at, 1, 0)
        + struct.pack("<QQ", btree_at, heap_at))
    w.parts.append((0, superblock))

    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as fh:
            fh.truncate(eof)
            for a, data in sorted(w.parts, key=lambda x: x[0]):
                fh.seek(a)
                fh.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
