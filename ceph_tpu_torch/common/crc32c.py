"""crc32c with the reference's seed convention (reference:
src/common/crc32c.cc :: ceph_crc32c — running crc in, no final inversion).

Fast path is the native library (native/crc32c.cc, built with SSE4.2 by
native_oracle.py); fallback is a table-driven Python implementation so the
framework stays importable where the native toolchain is absent.
"""
from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli


def _make_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (_POLY ^ (c >> 1)) if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c_py(data, seed: int) -> int:
    crc = seed & 0xFFFFFFFF
    for b in memoryview(data).cast("B"):
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


_native = None
_native_checked = False


def crc32c(data, seed: int = 0xFFFFFFFF) -> int:
    """crc32c of a bytes-like object, seeded (default -1, the reference's
    usual seed for frame/checksum computation)."""
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from .. import native_oracle

            if native_oracle.available():
                _native = native_oracle.crc32c
        except Exception:
            _native = None
    if _native is not None:
        return _native(data, seed)
    return _crc32c_py(data, seed)
