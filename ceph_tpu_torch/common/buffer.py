"""BufferList — chained zero-copy buffers (reference: src/include/buffer.h ::
ceph::buffer::list, src/common/buffer.cc).

The type that crosses every I/O interface in the reference — messenger frame
segments, ObjectStore transactions, and the `encode_chunks` host boundary.
Here it wraps a chain of memoryviews: appends never copy, `to_bytes()`
flattens once and caches, and `crc32c` / `substr` / alignment helpers mirror
the reference API surface the runtime layers need.  Little-endian fixed-width
encode/decode helpers replace the reference's encode.h templates for wire and
store formats.
"""
from __future__ import annotations

import struct

from .crc32c import crc32c as _crc32c


class BufferList:
    """Append-only chain of bytes-like segments with lazy flattening."""

    __slots__ = ("_segs", "_len", "_flat")

    def __init__(self, data: bytes | bytearray | memoryview | "BufferList" | None = None):
        self._segs: list[memoryview] = []
        self._len = 0
        self._flat: bytes | None = None
        if data is not None:
            self.append(data)

    # -- building ---------------------------------------------------------
    def append(self, data) -> "BufferList":
        if isinstance(data, BufferList):
            self._segs.extend(data._segs)
            self._len += data._len
        else:
            mv = memoryview(data).cast("B")
            if len(mv):
                self._segs.append(mv)
                self._len += len(mv)
        self._flat = None
        return self

    def append_zero(self, n: int) -> "BufferList":
        return self.append(bytes(n))

    def claim_append(self, other: "BufferList") -> "BufferList":
        """reference: bufferlist::claim_append — move segments, empty other."""
        self.append(other)
        other.clear()
        return self

    def clear(self) -> None:
        self._segs.clear()
        self._len = 0
        self._flat = None

    # -- struct-style encode helpers (little-endian, reference encode.h) --
    def append_u8(self, v: int) -> "BufferList":
        return self.append(struct.pack("<B", v))

    def append_u16(self, v: int) -> "BufferList":
        return self.append(struct.pack("<H", v))

    def append_u32(self, v: int) -> "BufferList":
        return self.append(struct.pack("<I", v))

    def append_u64(self, v: int) -> "BufferList":
        return self.append(struct.pack("<Q", v))

    def append_str(self, s: str | bytes) -> "BufferList":
        b = s.encode() if isinstance(s, str) else bytes(s)
        self.append_u32(len(b))
        return self.append(b)

    # -- reading ----------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def length(self) -> int:
        return self._len

    def to_bytes(self) -> bytes:
        if self._flat is None:
            self._flat = b"".join(self._segs)
        return self._flat

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return self.to_bytes() == bytes(other)
        if isinstance(other, BufferList):
            return self.to_bytes() == other.to_bytes()
        return NotImplemented

    def __hash__(self):  # flat content identity, like bufferlist operator==
        return hash(self.to_bytes())

    def substr(self, off: int, length: int) -> "BufferList":
        """Zero-copy sub-range (reference: bufferlist::substr_of)."""
        if off < 0 or length < 0 or off + length > self._len:
            raise IndexError(f"substr({off}, {length}) out of range 0..{self._len}")
        out = BufferList()
        pos = 0
        for seg in self._segs:
            if length == 0:
                break
            end = pos + len(seg)
            if end <= off:
                pos = end
                continue
            start = max(off, pos) - pos
            take = min(len(seg) - start, length)
            out.append(seg[start : start + take])
            off += take
            length -= take
            pos = end
        return out

    def crc32c(self, seed: int = 0xFFFFFFFF) -> int:
        crc = seed
        for seg in self._segs:
            crc = _crc32c(seg, crc)
        return crc

    def is_contiguous(self) -> bool:
        return len(self._segs) <= 1

    def rebuild(self) -> None:
        """Coalesce into one segment (reference: bufferlist::rebuild)."""
        flat = self.to_bytes()
        self._segs = [memoryview(flat)] if flat else []

    def rebuild_aligned(self, align: int) -> None:
        """Pad with zeros to a multiple of `align` and coalesce (reference:
        bufferlist::rebuild_aligned — DMA/chunk alignment before encode)."""
        pad = (-self._len) % align
        if pad:
            self.append_zero(pad)
        self.rebuild()

    # -- iterator-style decode --------------------------------------------
    def iterator(self) -> "BufferListIterator":
        return BufferListIterator(self.to_bytes())


class BufferListIterator:
    """Sequential decoder over a flattened BufferList (reference:
    bufferlist::iterator + denc decode)."""

    __slots__ = ("_data", "_off")

    def __init__(self, data: bytes):
        self._data = data
        self._off = 0

    def remaining(self) -> int:
        return len(self._data) - self._off

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._data):
            raise EOFError(
                f"decode past end: need {n}, have {self.remaining()}"
            )
        out = self._data[self._off : self._off + n]
        self._off += n
        return out

    def get_u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def get_u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def get_u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def get_u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def get_bytes(self, n: int) -> bytes:
        return self._take(n)

    def get_str(self) -> str:
        return self._take(self.get_u32()).decode()

    def get_str_bytes(self) -> bytes:
        return self._take(self.get_u32())
