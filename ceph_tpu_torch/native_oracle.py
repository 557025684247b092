"""ctypes bridge to the C++ oracles in native/ (the port's copy of
ceph_tpu/native_oracle.py).

The oracles are the framework's stand-in for the reference's native
jerasure/gf-complete/ISA-L/mapper.c stack (SURVEY.md §7 "native/"): they are
the bit-exactness referees and the CPU baseline for BASELINE.md.  pybind11
is not in this image, so the bridge is plain ctypes over a C ABI.

The loader reads native/ and writes nothing there: at first use g++
compiles native/'s sources into build/ceph_tpu_torch/, under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
and a built one is reused.  native/crush_tables.h is the C++ oracle's copy
of crush/ln_table.py's CRUSH_LN_TABLE (the tests hold the two equal).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "ceph_tpu_torch"
#: native/Makefile's flags, with SSE4.2 (crc32c's instruction) named
#: instead of -march=native, so a library built on one x86-64 host loads
#: on another
_CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


class OracleUnavailable(RuntimeError):
    pass


def _library_path() -> Path:
    """The oracle library for native/'s sources as they stand, built into
    build/ceph_tpu_torch/ if it is not there yet."""
    srcs = sorted(p for p in _NATIVE_DIR.iterdir() if p.suffix in (".cc", ".h"))
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for s in srcs:
        h.update(s.name.encode() + s.read_bytes())
    path = _BUILD_DIR / f"libceph_tpu_oracle_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cc = [str(s) for s in srcs if s.suffix == ".cc"]
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", str(tmp), *cc],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise OracleUnavailable(f"failed to build the native oracle: {detail}") from e
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_library_path()))

    lib.gfo_mul.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gfo_mul.restype = ctypes.c_int
    lib.gfo_div.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gfo_div.restype = ctypes.c_int
    lib.gfo_n_ones.argtypes = [ctypes.c_int]
    lib.gfo_n_ones.restype = ctypes.c_int
    lib.gfo_mul_table.argtypes = [_u8p]
    lib.gfo_mul_table.restype = None
    for name in ("gfo_vandermonde", "gfo_cauchy_original", "gfo_cauchy_good"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, _u8p]
        fn.restype = ctypes.c_int
    lib.gfo_invert.argtypes = [_u8p, ctypes.c_int, _u8p]
    lib.gfo_invert.restype = ctypes.c_int
    lib.gfo_apply.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long, _u8p]
    lib.gfo_apply.restype = None
    lib.gfo_apply_fast.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long, _u8p]
    lib.gfo_apply_fast.restype = ctypes.c_int
    lib.gfo_encode.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long, _u8p]
    lib.gfo_encode.restype = None
    lib.gfo_encode_fast.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long, _u8p]
    lib.gfo_encode_fast.restype = ctypes.c_int
    lib.gfo_decode.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int, _u8p,
        ctypes.c_long, _u8p,
    ]
    lib.gfo_decode.restype = ctypes.c_int
    for name in ("ceph_tpu_crc32c", "ceph_tpu_crc32c_sw"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_uint32, _u8p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint32
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except OracleUnavailable:
        return False


def gf_mul(a: int, b: int) -> int:
    return _lib().gfo_mul(a, b)


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    return _lib().gfo_div(a, b)


def n_ones(n: int) -> int:
    return _lib().gfo_n_ones(n)


def mul_table() -> np.ndarray:
    out = np.empty((256, 256), dtype=np.uint8)
    _lib().gfo_mul_table(out.reshape(-1))
    return out


def vandermonde(k: int, m: int) -> np.ndarray:
    out = np.empty(m * k, dtype=np.uint8)
    rc = _lib().gfo_vandermonde(k, m, out)
    if rc != 0:
        raise ValueError(f"gfo_vandermonde(k={k}, m={m}) failed rc={rc}")
    return out.reshape(m, k)


def cauchy_original(k: int, m: int) -> np.ndarray:
    out = np.empty(m * k, dtype=np.uint8)
    rc = _lib().gfo_cauchy_original(k, m, out)
    if rc != 0:
        raise ValueError(f"gfo_cauchy_original(k={k}, m={m}) failed rc={rc}")
    return out.reshape(m, k)


def cauchy_good(k: int, m: int) -> np.ndarray:
    out = np.empty(m * k, dtype=np.uint8)
    rc = _lib().gfo_cauchy_good(k, m, out)
    if rc != 0:
        raise ValueError(f"gfo_cauchy_good(k={k}, m={m}) failed rc={rc}")
    return out.reshape(m, k)


def invert(mat: np.ndarray) -> np.ndarray:
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    out = np.empty((n, n), dtype=np.uint8)
    rc = _lib().gfo_invert(mat.reshape(-1), n, out.reshape(-1))
    if rc != 0:
        raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
    return out


def encode(coding: np.ndarray, data: np.ndarray, fast: bool = False) -> np.ndarray:
    """Parity via the oracle; data [k, len] uint8 -> [m, len] uint8."""
    coding = np.ascontiguousarray(coding, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = coding.shape
    assert data.shape[0] == k
    length = data.shape[1]
    parity = np.empty((m, length), dtype=np.uint8)
    fn = _lib().gfo_encode_fast if fast else _lib().gfo_encode
    fn(coding.reshape(-1), k, m, data.reshape(-1), length, parity.reshape(-1))
    return parity


def apply_matrix(mat: np.ndarray, chunks: np.ndarray, fast: bool = True) -> np.ndarray:
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    rows, n = mat.shape
    assert chunks.shape[0] == n
    length = chunks.shape[1]
    out = np.empty((rows, length), dtype=np.uint8)
    fn = _lib().gfo_apply_fast if fast else _lib().gfo_apply
    fn(mat.reshape(-1), rows, n, chunks.reshape(-1), length, out.reshape(-1))
    return out


def crc32c(data, seed: int = 0xFFFFFFFF, _sw: bool = False) -> int:
    """crc32c over bytes-like data, reference convention (no final xor;
    reference: src/common/crc32c.cc :: ceph_crc32c).  _sw forces the
    table-driven path so tests can cross-check the hardware instruction."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    fn = _lib().ceph_tpu_crc32c_sw if _sw else _lib().ceph_tpu_crc32c
    return int(fn(seed & 0xFFFFFFFF, buf, buf.size))


def decode(
    coding: np.ndarray, k: int, available_rows: list[int], shards: np.ndarray
) -> np.ndarray:
    """Rebuild data chunks [k, len] from >= k shard rows (sorted ids)."""
    coding = np.ascontiguousarray(coding, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    m = coding.shape[0]
    rows = np.asarray(available_rows, dtype=np.int32)
    if shards.shape[0] < min(len(rows), k):
        raise ValueError(
            f"shards has {shards.shape[0]} rows, need >= {min(len(rows), k)}"
        )
    length = shards.shape[1]
    out = np.empty((k, length), dtype=np.uint8)
    rc = _lib().gfo_decode(
        coding.reshape(-1), k, m, rows, len(rows), shards.reshape(-1), length,
        out.reshape(-1),
    )
    if rc != 0:
        raise ValueError(f"gfo_decode failed rc={rc}")
    return out
