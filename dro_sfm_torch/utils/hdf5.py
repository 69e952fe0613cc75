"""A read-only reader of the HDF5 files that h5py writes by default.

The card's machine has no h5py, and NYU's processed dumps are HDF5
(`data/nyu.py`). `open_h5(path)` reads the file once and returns a mapping
of dataset path (``"rgb"``, ``"group/depth"``) to numpy array; each array is
decoded when it is first looked up.

What it reads, after the HDF5 file format specification (version 3.0):

* superblock versions 0 and 1 (``libver="earliest"``, h5py's default) with
  groups as symbol tables: a v1 B-tree of type 0 over ``SNOD`` nodes and a
  local heap of names; and versions 2 and 3 (``libver="latest"``) with
  groups of compact link messages;
* object headers of version 1 and 2, with continuation blocks;
* dataspace messages of versions 1 and 2;
* datatype classes 0 (fixed-point) and 1 (IEEE float) of 1, 2, 4 or 8 bytes
  in either byte order;
* data layout messages of versions 3 and 4: compact, contiguous and chunked;
  chunks indexed by a v1 B-tree of type 1 (version 3), or by a single
  chunk, the implicit index or an unpaged fixed array (version 4); edge
  chunks that overhang the shape are cut;
* filter pipelines of versions 1 and 2 with deflate (1) and shuffle (2),
  undone in reverse order and skipped where a chunk's filter mask says so;
* an undefined address or a chunk never written: the fill value (zeros
  unless the fill value message defines another).

Anything else raises `NotImplementedError` naming the feature and its
version (another filter such as Fletcher32 or szip, a fractal heap of dense
links, variable-length, string or compound types, a paged fixed array, an
extensible array or a v2 B-tree chunk index). No checksum is verified. The
reader never guesses: what it cannot decode exactly, it refuses.
"""
from __future__ import annotations

import struct
import zlib
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = object()            # an address of all ones

# Object header message types used here.
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE, MSG_FILL_OLD, MSG_FILL = 0x1, 0x2, 0x3, 0x4, 0x5
MSG_LINK, MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x6, 0x8, 0xB, 0x10, 0x11
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
FILTER_NAMES = {3: "Fletcher32", 4: "szip", 5: "N-bit", 6: "scale-offset"}
TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}


class _Reader:
    """Little-endian fields of the file's bytes at a moving position."""

    def __init__(self, buf: memoryview, pos: int, size_offsets: int = 8,
                 size_lengths: int = 8):
        self.buf, self.pos = buf, pos
        self.so, self.sl = size_offsets, size_lengths

    def uint(self, n: int) -> int:
        if self.pos + n > len(self.buf):
            raise ValueError(f"HDF5 file truncated: a field at byte {self.pos} runs past "
                             f"its end ({len(self.buf)} bytes)")
        v = int.from_bytes(self.buf[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def bytes(self, n: int) -> bytes:
        out = bytes(self.buf[self.pos:self.pos + n])
        if len(out) != n:
            raise ValueError(f"HDF5 file truncated at byte {self.pos}")
        self.pos += n
        return out

    def offset(self):
        v = self.uint(self.so)
        return UNDEFINED if v == (1 << (8 * self.so)) - 1 else v

    def length(self) -> int:
        return self.uint(self.sl)

    def at(self, pos: int) -> "_Reader":
        return _Reader(self.buf, pos, self.so, self.sl)

    def expect(self, sig: bytes, what: str) -> None:
        got = self.bytes(len(sig))
        if got != sig:
            raise ValueError(f"HDF5 {what} at byte {self.pos - len(sig)}: signature "
                             f"{got!r}, want {sig!r}")


def _unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5 {feature} is not supported by dro_sfm_torch's reader")


class _Dataset:
    """What one dataset's object header says: shape, dtype, layout,
    filters, fill value."""

    def __init__(self, name: str, messages: List[Tuple[int, memoryview]],
                 size_lengths: int):
        self.name = name
        self.shape: Optional[Tuple[int, ...]] = None
        self.dtype: Optional[np.dtype] = None
        self.layout: Optional[memoryview] = None
        self.filters: List[Tuple[int, int]] = []     # (id, flags), in write order
        self.fill: Optional[bytes] = None
        for mtype, body in messages:
            if mtype == MSG_DATASPACE:
                self.shape = _dataspace(body, size_lengths)
            elif mtype == MSG_DATATYPE:
                self.dtype = _datatype(body)
            elif mtype == MSG_LAYOUT:
                self.layout = body
            elif mtype == MSG_FILTERS:
                self.filters = _filters(body)
            elif mtype == MSG_FILL:
                self.fill = _fill_value(body)
            elif mtype == MSG_FILL_OLD and self.fill is None:
                size = int.from_bytes(body[:4], "little")
                self.fill = bytes(body[4:4 + size]) if size else None
        if self.shape is None or self.dtype is None or self.layout is None:
            raise ValueError(f"HDF5 dataset {name!r}: its object header lacks a dataspace, "
                             "datatype or layout message")
        if self.fill is not None and len(self.fill) != self.dtype.itemsize:
            raise _unsupported(f"fill value of {len(self.fill)} bytes for a "
                               f"{self.dtype.itemsize}-byte type")


def _dataspace(body: memoryview, sl: int) -> Tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise _unsupported("null dataspace")
        pos = 4
    else:
        raise _unsupported(f"dataspace message version {version}")
    if flags & 2 and version == 1:
        raise _unsupported("dataspace permutation index")
    return tuple(int.from_bytes(body[pos + sl * i:pos + sl * (i + 1)], "little")
                 for i in range(rank))


def _datatype(body: memoryview) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = body[1] | body[2] << 8 | body[3] << 16
    size = int.from_bytes(body[4:8], "little")
    if version not in (1, 2, 3, 4):
        raise _unsupported(f"datatype message version {version}")
    if cls not in (0, 1):
        raise _unsupported(f"datatype class {cls} ({TYPE_CLASSES.get(cls, 'unknown')}), "
                           f"version {version}")
    offset, precision = struct.unpack_from("<HH", body, 8)
    if offset != 0 or precision != 8 * size:
        raise _unsupported(f"datatype of {precision} bits at bit offset {offset} in "
                           f"{size} bytes")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise _unsupported(f"fixed-point datatype of {size} bytes")
        kind = "i" if bits & 0x08 else "u"
        order = ">" if bits & 0x01 else "<"
    else:
        if bits & 0x40:
            raise _unsupported("VAX-endian floating point")
        if size not in (2, 4, 8):
            raise _unsupported(f"floating-point datatype of {size} bytes")
        # IEEE layouts only: sign bit on top, the exponent and mantissa where
        # numpy's half, single and double keep them.
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                8: (63, 52, 11, 0, 52, 1023)}[size]
        sign = bits >> 8 & 0xFF
        exp_loc, exp_size, man_loc, man_size = body[12], body[13], body[14], body[15]
        bias = int.from_bytes(body[16:20], "little")
        if (sign, exp_loc, exp_size, man_loc, man_size, bias) != ieee:
            raise _unsupported(f"non-IEEE floating-point layout of {size} bytes")
        kind = "f"
        order = ">" if bits & 0x01 else "<"
    return np.dtype(f"{order}{kind}{size}")


def _filters(body: memoryview) -> List[Tuple[int, int]]:
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise _unsupported(f"filter pipeline message version {version}")
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid, = struct.unpack_from("<H", body, pos)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len, = struct.unpack_from("<H", body, pos)
            pos += 2
        flags, n_values = struct.unpack_from("<HH", body, pos)
        pos += 4
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        pos += 4 * n_values
        if version == 1 and n_values % 2:
            pos += 4
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise _unsupported(f"filter {fid} ({FILTER_NAMES.get(fid, 'unknown')}) in a "
                               f"filter pipeline message version {version}")
        out.append((fid, flags))
    return out


def _fill_value(body: memoryview) -> Optional[bytes]:
    version = body[0]
    if version in (1, 2):
        defined, pos = body[3], 4
        if version == 2 and not defined:
            return None
        size = int.from_bytes(body[pos:pos + 4], "little")
        return bytes(body[pos + 4:pos + 4 + size]) if size else None
    if version == 3:
        flags = body[1]
        if not flags & 0x20:
            return None
        size = int.from_bytes(body[2:6], "little")
        return bytes(body[6:6 + size])
    raise _unsupported(f"fill value message version {version}")


class H5File(Mapping):
    """The datasets of one HDF5 file, by path; see the module docstring.
    The file is read once into memory; ``file[name]`` decodes a dataset
    into a new numpy array."""

    def __init__(self, path):
        self.path = str(path)
        self._buf = memoryview(Path(path).read_bytes())
        self._datasets: Dict[str, List[Tuple[int, memoryview]]] = {}   # messages
        root = self._superblock()
        self._walk_group(root, "")

    # -- structure ---------------------------------------------------------

    def _superblock(self) -> int:
        buf = self._buf
        # the superblock sits at 0, 512, 1024, ... (a user block before it)
        base = 0
        while buf[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base + 8 > len(buf):
                raise ValueError(f"{self.path}: not an HDF5 file (no signature)")
        version = buf[base + 8]
        if version in (0, 1):
            r = _Reader(buf, base + 9)
            r.uint(3)                                   # free space, root table, reserved
            r.uint(1)                                   # shared header version
            so, sl = r.uint(1), r.uint(1)
            r.uint(1)
            r.uint(4)                                   # group leaf and internal K
            r.uint(4)                                   # consistency flags
            if version == 1:
                r.uint(4)                               # indexed storage K, reserved
            self._r = _Reader(buf, 0, so, sl)
            r.so, r.sl = so, sl
            base_address = r.offset()
            r.offset(), r.offset(), r.offset()          # free space, end of file, VFD info
            r.offset()                                  # root entry: link name offset
            root = r.offset()
        elif version in (2, 3):
            so, sl = buf[base + 9], buf[base + 10]
            r = _Reader(buf, base + 12, so, sl)
            self._r = _Reader(buf, 0, so, sl)
            base_address = r.offset()
            extension = r.offset()
            if extension is not UNDEFINED:
                raise _unsupported(f"superblock extension (superblock version {version})")
            r.offset()                                  # end of file
            root = r.offset()
        else:
            raise _unsupported(f"superblock version {version}")
        if base_address not in (0, base):
            raise _unsupported(f"base address {base_address}")
        self._base = base_address
        return root

    def _messages(self, address: int) -> List[Tuple[int, memoryview]]:
        """The (type, body) of every message of the object header at
        ``address``, its continuation blocks included."""
        buf, r = self._buf, self._r.at(self._base + address)
        out: List[Tuple[int, memoryview]] = []
        blocks: List[Tuple[int, int]] = []
        if bytes(buf[r.pos:r.pos + 4]) == b"OHDR":
            r.pos += 4
            version = r.uint(1)
            if version != 2:
                raise _unsupported(f"object header version {version}")
            flags = r.uint(1)
            if flags & 0x20:
                r.uint(16)                              # times
            if flags & 0x10:
                r.uint(4)                               # attribute phase change
            size = r.uint(1 << (flags & 3))
            blocks.append((r.pos, r.pos + size))
            creation_order = bool(flags & 0x04)
            while blocks:
                start, end = blocks.pop(0)
                pos = start
                while pos + 4 <= end:
                    mtype = buf[pos]
                    msize = int.from_bytes(buf[pos + 1:pos + 3], "little")
                    pos += 4 + (2 if creation_order else 0)
                    body = buf[pos:pos + msize]
                    pos += msize
                    if mtype == MSG_CONTINUATION:
                        c = _Reader(body, 0, self._r.so, self._r.sl)
                        addr, length = c.offset(), c.length()
                        cont = self._base + addr
                        if bytes(buf[cont:cont + 4]) != b"OCHK":
                            raise ValueError(f"{self.path}: continuation block at {cont} "
                                             "lacks its OCHK signature")
                        blocks.append((cont + 4, cont + length - 4))   # minus checksum
                    else:
                        out.append((mtype, body))
            return out
        version = r.uint(1)
        if version != 1:
            raise _unsupported(f"object header version {version}")
        r.uint(3)                                       # reserved, number of messages
        r.uint(4)                                       # reference count
        size = r.uint(4)
        start = r.pos + 4                               # the prefix padded to 16 bytes
        blocks.append((start, start + size))
        while blocks:                                   # each block is all messages
            start, end = blocks.pop(0)
            pos = start
            while pos + 8 <= end:
                mtype = int.from_bytes(buf[pos:pos + 2], "little")
                msize = int.from_bytes(buf[pos + 2:pos + 4], "little")
                body = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    c = _Reader(body, 0, self._r.so, self._r.sl)
                    addr, length = c.offset(), c.length()
                    blocks.append((self._base + addr, self._base + addr + length))
                else:
                    out.append((mtype, body))
        return out

    def _walk_group(self, address: int, prefix: str) -> None:
        messages = self._messages(address)
        types = {t for t, _ in messages}
        if MSG_SYMBOL_TABLE in types:
            body = next(b for t, b in messages if t == MSG_SYMBOL_TABLE)
            r = _Reader(body, 0, self._r.so, self._r.sl)
            btree, heap = r.offset(), r.offset()
            names = self._local_heap(heap)
            for name_off, child in self._group_btree(btree):
                self._add(prefix + _cstring(names, name_off), child)
        elif MSG_LINK_INFO in types:
            body = next(b for t, b in messages if t == MSG_LINK_INFO)
            r = _Reader(body, 2 + (8 if body[1] & 1 else 0), self._r.so, self._r.sl)
            if r.offset() is not UNDEFINED:
                raise _unsupported("group of dense links (a fractal heap)")
            for t, b in messages:
                if t == MSG_LINK:
                    name, child = self._link(b)
                    if child is not None:
                        self._add(prefix + name, child)
        elif MSG_LAYOUT not in types:
            raise _unsupported("group without a symbol table or link info message")

    def _add(self, path: str, address: int) -> None:
        messages = self._messages(address)
        types = {t for t, _ in messages}
        if MSG_SYMBOL_TABLE in types or MSG_LINK_INFO in types:
            self._walk_group(address, path + "/")
        elif MSG_LAYOUT in types:
            self._datasets[path] = messages
        # a named datatype or another object: not a dataset, not listed

    def _link(self, body: memoryview):
        """(name, object header address) of a link message; address None
        for a soft or external link."""
        r = _Reader(body, 0, self._r.so, self._r.sl)
        version, flags = r.uint(1), r.uint(1)
        if version != 1:
            raise _unsupported(f"link message version {version}")
        link_type = r.uint(1) if flags & 0x08 else 0
        if flags & 0x04:
            r.uint(8)                                   # creation order
        if flags & 0x10:
            r.uint(1)                                   # character set
        name = r.bytes(r.uint(1 << (flags & 3))).decode("utf-8")
        return name, (r.offset() if link_type == 0 else None)

    def _local_heap(self, address: int) -> memoryview:
        r = self._r.at(self._base + address)
        r.expect(b"HEAP", "local heap")
        r.uint(4)                                       # version, reserved
        size = r.length()
        r.length()                                      # free list
        data = r.offset()
        return self._buf[self._base + data:self._base + data + size]

    def _group_btree(self, address: int) -> Iterator[Tuple[int, int]]:
        """(name offset in the heap, object header address) of every entry
        of a group's v1 B-tree (type 0) and its symbol nodes."""
        r = self._r.at(self._base + address)
        r.expect(b"TREE", "group B-tree node")
        node_type, level, entries = r.uint(1), r.uint(1), r.uint(2)
        if node_type != 0:
            raise ValueError(f"{self.path}: group B-tree node of type {node_type}")
        r.offset(), r.offset()                          # siblings
        children = []
        for _ in range(entries):
            r.length()                                  # key: heap offset
            children.append(r.offset())
        for child in children:
            if level > 0:
                yield from self._group_btree(child)
                continue
            s = self._r.at(self._base + child)
            s.expect(b"SNOD", "symbol table node")
            s.uint(2)                                   # version, reserved
            for _ in range(s.uint(2)):
                name_off, header = s.offset(), s.offset()
                s.uint(4 + 4 + 16)                      # cache type, reserved, scratch
                yield name_off, header

    # -- data --------------------------------------------------------------

    def __getitem__(self, name: str) -> np.ndarray:
        ds = _Dataset(name, self._datasets[name], self._r.sl)
        body = ds.layout
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise _unsupported(f"data layout message version {version}")
        r = _Reader(body, 2, self._r.so, self._r.sl)
        n = int(np.prod(ds.shape, dtype=np.int64))
        nbytes = n * ds.dtype.itemsize
        if cls == 0:                                    # compact
            size = r.uint(2)
            raw = r.bytes(size)
            if size != nbytes:
                raise ValueError(f"{self.path}:{name}: compact data of {size} bytes for "
                                 f"{nbytes}")
            return np.frombuffer(raw, ds.dtype).reshape(ds.shape).copy()
        if cls == 1:                                    # contiguous
            address, size = r.offset(), r.length()
            if address is UNDEFINED:
                return self._filled(ds, ds.shape)
            start = self._base + address
            if size < nbytes or start + nbytes > len(self._buf):
                raise ValueError(f"{self.path}:{name}: contiguous data of {size} bytes "
                                 f"at {start} for {nbytes}")
            return np.frombuffer(self._buf[start:start + nbytes], ds.dtype).reshape(
                ds.shape).copy()
        if cls == 2:
            return self._chunked(ds, r, version)
        raise _unsupported(f"layout class {cls} (virtual) in layout version {version}")

    def _filled(self, ds: _Dataset, shape) -> np.ndarray:
        if ds.fill is None:
            return np.zeros(shape, ds.dtype)
        return np.full(shape, np.frombuffer(ds.fill, ds.dtype)[0], ds.dtype)

    def _chunked(self, ds: _Dataset, r: _Reader, version: int) -> np.ndarray:
        rank = len(ds.shape)
        flags = 0
        if version == 3:
            dims = r.uint(1)
            address = r.offset()
            chunk = tuple(r.uint(4) for _ in range(dims))
        else:
            flags, dims, enc = r.uint(1), r.uint(1), r.uint(1)
            chunk = tuple(r.uint(enc) for _ in range(dims))
        if dims == rank + 1:                            # the element size comes last
            chunk = chunk[:rank]
        elif not (version == 4 and dims == rank):
            raise ValueError(f"{self.path}:{ds.name}: chunk of rank {dims} for data of "
                             f"rank {rank}")
        out = self._filled(ds, ds.shape)
        if version == 3:
            chunks = self._chunk_btree(address, rank) if address is not UNDEFINED else []
        else:
            chunks = self._chunk_index(ds, r, chunk, bool(flags & 2))
        for offsets, addr, size, mask in chunks:
            if any(o >= s for o, s in zip(offsets, ds.shape)):
                continue
            # layout flag 1: edge chunks were stored without the filters
            edge = any(o + c > s for o, c, s in zip(offsets, chunk, ds.shape))
            data = self._decode_chunk(ds, addr, size, mask, chunk, bool(flags & 1) and edge)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, ds.shape))
            out[region] = data[tuple(slice(0, sl.stop - sl.start) for sl in region)]
        return out

    def _decode_chunk(self, ds: _Dataset, address: int, size: int, mask: int,
                      chunk: Tuple[int, ...], skip_filters: bool) -> np.ndarray:
        start = self._base + address
        raw = self._buf[start:start + size]
        if len(raw) != size:
            raise ValueError(f"{self.path}:{ds.name}: chunk at {start} runs past the file")
        item = ds.dtype.itemsize
        if not skip_filters:
            for i in reversed(range(len(ds.filters))):
                if mask >> i & 1:
                    continue                            # this filter skipped the chunk
                fid, _ = ds.filters[i]
                if fid == FILTER_DEFLATE:
                    raw = zlib.decompress(raw)
                elif fid == FILTER_SHUFFLE and item > 1:
                    arr = np.frombuffer(raw, np.uint8)
                    whole = len(arr) // item * item
                    raw = (arr[:whole].reshape(item, -1).T.tobytes()
                           + arr[whole:].tobytes())
        want = int(np.prod(chunk, dtype=np.int64)) * item
        if len(raw) < want:
            raise ValueError(f"{self.path}:{ds.name}: a chunk decodes to {len(raw)} "
                             f"bytes, want {want}")
        return np.frombuffer(bytes(raw[:want]), ds.dtype).reshape(chunk)

    def _chunk_btree(self, address: int, rank: int):
        """(offsets, address, size, filter mask) of every chunk of a v1
        B-tree of type 1."""
        r = self._r.at(self._base + address)
        r.expect(b"TREE", "chunk B-tree node")
        node_type, level, entries = r.uint(1), r.uint(1), r.uint(2)
        if node_type != 1:
            raise ValueError(f"{self.path}: chunk B-tree node of type {node_type}")
        r.offset(), r.offset()
        out = []
        for _ in range(entries):
            size, mask = r.uint(4), r.uint(4)
            offsets = tuple(r.uint(8) for _ in range(rank + 1))[:rank]
            child = r.offset()
            if level > 0:
                out.extend(self._chunk_btree(child, rank))
            else:
                out.append((offsets, child, size, mask))
        return out

    def _chunk_index(self, ds: _Dataset, r: _Reader, chunk: Tuple[int, ...],
                     filtered_single: bool):
        """The chunks of a version 4 layout: single chunk, implicit or an
        unpaged fixed array."""
        kind = r.uint(1)
        grid = [-(-s // c) for s, c in zip(ds.shape, chunk)]
        n_chunks = int(np.prod(grid, dtype=np.int64))
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * ds.dtype.itemsize

        def offsets(i):
            out = []
            for g, c in zip(reversed(grid), reversed(chunk)):
                out.append(i % g * c)
                i //= g
            return tuple(reversed(out))

        if kind == 1:                                   # single chunk
            size, mask = chunk_bytes, 0
            if filtered_single:
                size, mask = r.length(), r.uint(4)
            address = r.offset()
            return [] if address is UNDEFINED else [((0,) * len(chunk), address, size, mask)]
        if kind == 2:                                   # implicit
            address = r.offset()
            if address is UNDEFINED:
                return []
            return [(offsets(i), address + i * chunk_bytes, chunk_bytes, 0)
                    for i in range(n_chunks)]
        if kind == 3:                                   # fixed array
            r.uint(1)                                   # page bits
            address = r.offset()
            if address is UNDEFINED:
                return []
            h = self._r.at(self._base + address)
            h.expect(b"FAHD", "fixed array header")
            h.uint(1)                                   # version
            client, entry_size, page_bits = h.uint(1), h.uint(1), h.uint(1)
            n_entries = h.length()
            block = h.offset()
            if n_entries > (1 << page_bits):
                raise _unsupported(f"paged fixed array chunk index ({n_entries} chunks)")
            if n_entries != n_chunks:
                raise ValueError(f"{self.path}:{ds.name}: fixed array of {n_entries} "
                                 f"entries for {n_chunks} chunks")
            if block is UNDEFINED:
                return []
            d = self._r.at(self._base + block)
            d.expect(b"FADB", "fixed array data block")
            d.uint(2)                                   # version, client
            d.offset()                                  # header address
            out = []
            for i in range(n_entries):
                addr = d.offset()
                size, mask = chunk_bytes, 0
                if client == 1:
                    size = d.uint(entry_size - d.so - 4)
                    mask = d.uint(4)
                if addr is not UNDEFINED:
                    out.append((offsets(i), addr, size, mask))
            return out
        names = {4: "extensible array", 5: "version 2 B-tree"}
        raise _unsupported(f"{names.get(kind, f'type {kind}')} chunk index "
                           "(data layout message version 4)")

    def __iter__(self):
        return iter(self._datasets)

    def __len__(self):
        return len(self._datasets)


def _cstring(heap: memoryview, offset: int) -> str:
    end = bytes(heap[offset:]).index(b"\0")
    return bytes(heap[offset:offset + end]).decode("utf-8")


def open_h5(path) -> H5File:
    """The datasets of the HDF5 file at ``path``: a mapping of dataset path
    to numpy array (see the module docstring for what it reads)."""
    return H5File(path)
