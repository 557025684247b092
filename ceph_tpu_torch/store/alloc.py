"""Block allocator binding (reference: src/os/bluestore/Allocator.h and
its Bitmap/Avl implementations; SURVEY.md §2.4 "allocators").

Uses the native next-fit bitmap allocator (native/allocator.cc) via
ctypes when the oracle .so is built, else a pure-Python bitmap with the
same behavior.  Extents are (start_block, n_blocks) runs.
"""
from __future__ import annotations

import ctypes
import os
from ..common.lockdep import make_lock

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        # native_oracle's loader rebuilds the .so when sources are newer,
        # so a stale library predating allocator.cc gets refreshed instead
        # of failing symbol lookup
        from ..native_oracle import _lib as _oracle_lib

        lib = _oracle_lib()
        lib.ctpu_alloc_create.restype = ctypes.c_void_p
        lib.ctpu_alloc_create.argtypes = [ctypes.c_uint64]
        lib.ctpu_alloc_destroy.argtypes = [ctypes.c_void_p]
        lib.ctpu_alloc_free_blocks.restype = ctypes.c_uint64
        lib.ctpu_alloc_free_blocks.argtypes = [ctypes.c_void_p]
        lib.ctpu_alloc_mark.restype = ctypes.c_int
        lib.ctpu_alloc_mark.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int
        ]
        lib.ctpu_alloc_allocate.restype = ctypes.c_int
        lib.ctpu_alloc_allocate.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ]
        _LIB = lib
    except (OSError, AttributeError, RuntimeError, ImportError):
        # missing .so, failed build, or a lib without the ctpu_alloc_*
        # symbols: fall back to the Python allocator
        _LIB = False
    return _LIB


class AllocError(RuntimeError):
    pass


class NativeBitmapAllocator:
    """ctypes wrapper over native/allocator.cc."""

    MAX_EXTENTS = 512

    def __init__(self, n_blocks: int):
        lib = _load_lib()
        if not lib:
            raise AllocError("native allocator unavailable")
        self._lib = lib
        self._h = lib.ctpu_alloc_create(n_blocks)
        if not self._h:
            raise AllocError("allocator create failed")
        self.n_blocks = n_blocks
        self._lock = make_lock("store::alloc")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ctpu_alloc_destroy(h)
            self._h = None

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return int(self._lib.ctpu_alloc_free_blocks(self._h))

    def mark_used(self, start: int, length: int) -> None:
        with self._lock:
            if self._lib.ctpu_alloc_mark(self._h, start, length, 0) != 0:
                raise AllocError(f"mark_used({start},{length}) out of range")

    def release(self, start: int, length: int) -> None:
        with self._lock:
            if self._lib.ctpu_alloc_mark(self._h, start, length, 1) != 0:
                raise AllocError(f"release({start},{length}) out of range")

    def allocate(self, want: int) -> list[tuple[int, int]]:
        out = (ctypes.c_uint64 * (2 * self.MAX_EXTENTS))()
        with self._lock:
            n = self._lib.ctpu_alloc_allocate(
                self._h, want, out, self.MAX_EXTENTS
            )
        if n < 0:
            raise AllocError(f"cannot allocate {want} blocks")
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


class PyBitmapAllocator:
    """Pure-Python next-fit bitmap with the native allocator's contract,
    including the MAX_EXTENTS fragmentation budget (so workloads pass or
    fail identically whichever implementation is loaded)."""

    MAX_EXTENTS = NativeBitmapAllocator.MAX_EXTENTS

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = bytearray(b"\x01") * n_blocks if n_blocks else bytearray()
        self._n_free = n_blocks
        self._cursor = 0
        self._lock = make_lock("store::alloc")

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return self._n_free

    def _mark_locked(self, start: int, length: int, free: bool) -> None:
        if start + length > self.n_blocks:
            raise AllocError(f"extent ({start},{length}) out of range")
        v = 1 if free else 0
        for i in range(start, start + length):
            if self._free[i] != v:
                self._free[i] = v
                self._n_free += 1 if free else -1

    def mark_used(self, start: int, length: int) -> None:
        with self._lock:
            self._mark_locked(start, length, False)

    def release(self, start: int, length: int) -> None:
        with self._lock:
            self._mark_locked(start, length, True)

    def allocate(self, want: int) -> list[tuple[int, int]]:
        with self._lock:
            if want == 0:
                return []
            if want > self._n_free:
                raise AllocError(f"cannot allocate {want} blocks")
            out: list[tuple[int, int]] = []
            got = 0
            pos = self._cursor % self.n_blocks
            scanned = 0
            while got < want and scanned < self.n_blocks:
                while scanned < self.n_blocks and not self._free[pos]:
                    pos += 1
                    scanned += 1
                    if pos >= self.n_blocks:
                        pos = 0
                if scanned >= self.n_blocks:
                    break
                run_start, run_len = pos, 0
                while (
                    scanned < self.n_blocks and got + run_len < want
                    and pos < self.n_blocks and self._free[pos]
                ):
                    run_len += 1
                    pos += 1
                    scanned += 1
                if run_len:
                    if len(out) >= self.MAX_EXTENTS:
                        raise AllocError(
                            f"allocation of {want} blocks exceeds the "
                            f"{self.MAX_EXTENTS}-extent budget"
                        )
                    out.append((run_start, run_len))
                    got += run_len
                if pos >= self.n_blocks:
                    pos = 0
            if got < want:
                raise AllocError(f"cannot allocate {want} blocks")
            for s, n in out:
                self._mark_locked(s, n, False)
            self._cursor = pos
            return out


def make_allocator(n_blocks: int):
    """Native when built, Python otherwise (same contract either way)."""
    try:
        return NativeBitmapAllocator(n_blocks)
    except AllocError:
        return PyBitmapAllocator(n_blocks)
