"""K1 and K2 — the GF(2^8) matrix apply on Hopper — and its plain version.

Counterpart of ceph_tpu/ops/pallas_gf.py.  The two CUDA kernels live in
csrc/gf_apply.cu and replace the two Pallas kernels one for one:

    gf_apply_k1  <- pallas_gf.py:184 ``_apply_kernel``          (rb == 1)
    gf_apply_k2  <- pallas_gf.py:202 ``_apply_kernel_blocked``  (rb > 1)

Both compute ``out[rows, L] = mat[rows, n] x in[n, L]`` over GF(2^8)
(polynomial 0x11d), bit-exact against gf/reference_codec.apply_matrix.
The apply is bound by memory: it reads n*L bytes and writes rows*L bytes.
The kernels look the products up in split-nibble tables (32 bytes per
matrix entry, built here by ``nibble_tables``) held in shared memory.
``kernel_for`` is the rule that picks one: K1 holds the whole matrix's
tables in one block; K2 stages the input tile and walks the rows in bands,
taking the inputs in chunks when they do not all fit (``k2_layout``).

The library is compiled by nvcc from the checkout's source at first use
into build/ceph_tpu_torch/ and bound with ctypes (plain C interface).  The
wrapper ``gf_apply`` launches a kernel for CUDA tensors and raises if the
build or the launch fails; for CPU tensors it runs ``apply_matrix_plain``,
the same function in plain PyTorch.  There is no fallback from one to the
other.  ``prepare`` stages a launch without running it (so a benchmark
can time the kernel apart from the host work of staging it).
``LAUNCHES`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..gf.matrix import matrix_to_bitmatrix
from ..gf.tables import GF_MUL_TABLE

#: accumulators a thread keeps: a K1 matrix or a K2 band has at most this
#: many rows (csrc: the largest MAXR instantiation)
MAX_ROWS = 16
#: split-nibble table bytes per matrix entry: lo[16] then hi[16]
TABLE_BYTES_PER_ENTRY = 32
#: THE K1/K2 rule: a matrix goes to K1 when rows <= MAX_ROWS and its
#: tables take at most this many bytes of the block's shared memory;
#: every other matrix goes to K2.  RS(8,4) encode [4, 8] takes 1 KiB and
#: its decode [8, 8] 2 KiB; CLAY(8,4,d=11) repair [64, 176] takes 352 KiB.
K1_MAX_TABLE_BYTES = 16 * 1024
#: K2 threads per block (csrc K2_THREADS): one 4-byte column word each
K2_THREADS = 128
#: dynamic shared memory one block may use on Hopper (227 KiB)
SMEM_PER_BLOCK = 232448

KERNELS = ("gf_apply_k1", "gf_apply_k2")
#: launches per kernel since the last reset_launch_counts()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gf_apply.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ceph_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: float32 bitplane bytes the plain version materializes per column chunk
_PLAIN_CHUNK_BYTES = 256 << 20


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_for(rows: int, n: int) -> str:
    """Which kernel applies a [rows, n] matrix (see K1_MAX_TABLE_BYTES)."""
    if rows <= MAX_ROWS and rows * n * TABLE_BYTES_PER_ENTRY <= K1_MAX_TABLE_BYTES:
        return "gf_apply_k1"
    return "gf_apply_k2"


def k2_smem_bytes(chunk_rows: int, band_rows: int) -> int:
    """K2's shared memory per block: a band's tables for one chunk of
    input rows + that chunk's input tile."""
    return (TABLE_BYTES_PER_ENTRY * band_rows + 4 * K2_THREADS) * chunk_rows


def k2_layout(rows: int, n: int) -> tuple[int, int]:
    """(band_rows, chunk_rows) of a K2 launch for a [rows, n] matrix.

    A band is up to MAX_ROWS output rows (their sums live in registers).
    The inputs go through in as few equal chunks as fit in shared memory
    beside a band's tables: one chunk (the tile staged once) for n up to
    227, e.g. CLAY(8,4,d=11) repair [64, 176]; five of 192 for
    CLAY(12,4,d=15) repair [256, 960]."""
    band = min(rows, MAX_ROWS)
    cap = SMEM_PER_BLOCK // k2_smem_bytes(1, band)
    chunks = -(-n // cap)
    return band, -(-n // chunks)


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """[rows, n, 32] uint8: entry (i, j) holds lo[x] = mat[i,j]*x and
    hi[x] = mat[i,j]*(x << 4) for x in 0..15, so that
    mat[i,j]*b = lo[b & 15] ^ hi[b >> 4]."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    x = np.arange(16, dtype=np.uint8)
    lo = GF_MUL_TABLE[mat[:, :, None], x[None, None, :]]
    hi = GF_MUL_TABLE[mat[:, :, None], (x << 4)[None, None, :]]
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=2))


# ---------------------------------------------------------------- build


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
#: nvcc's output from the build this process made (ptxas register and
#: shared-memory report), empty when the library was already built
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the GF kernels need the CUDA toolkit")


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled from SOURCE on first use.

    The file name carries a hash of the source and flags, so an edited
    source is rebuilt and a built one is reused."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libgf_apply_{tag}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gf_apply_k1_launch.argtypes = [p, i, i, p, i, ll, p, ll, p]
        lib.gf_apply_k1_launch.restype = i
        lib.gf_apply_k2_launch.argtypes = [p, i, i, i, i, p, i, ll, p, ll, p]
        lib.gf_apply_k2_launch.restype = i
        _lib = lib
        return lib


# ------------------------------------------------------------ plain version


@lru_cache(maxsize=64)
def _bitmatrix(mat_bytes: bytes, shape: tuple[int, int], device: str) -> torch.Tensor:
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(shape)
    bm = matrix_to_bitmatrix(mat).astype(np.float32)
    return torch.from_numpy(bm).to(device)


def apply_matrix_plain(mat: np.ndarray, chunks: torch.Tensor) -> torch.Tensor:
    """The GF(2^8) apply in plain PyTorch, on the tensor's own device.

    Unpacks the bytes into 8 bit-planes, multiplies by the GF(2)
    bitmatrix in float32 (exact: every sum is at most 8*n <= 2^24), takes
    the sums mod 2 and packs the bits back, one column chunk at a time so
    a long L needs no 8x copy of the input."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    rows, n = mat.shape
    if chunks.dtype != torch.uint8 or chunks.dim() != 2 or chunks.shape[0] != n:
        raise ValueError(f"want a [{n}, L] uint8 tensor, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    dev = chunks.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    L = chunks.shape[1]
    out = torch.empty((rows, L), dtype=torch.uint8, device=dev)
    if rows == 0 or L == 0:
        return out
    B = _bitmatrix(mat.tobytes(), mat.shape, str(dev))
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * 8 * max(n, rows, 1)))
    for c0 in range(0, L, step):
        x = chunks[:, c0:c0 + step]
        bits = ((x[:, None, :] >> shifts[None, :, None]) & 1).reshape(n * 8, -1)
        acc = B @ bits.to(torch.float32)
        par = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(rows, 8, -1)
        out[:, c0:c0 + step] = (par << shifts[None, :, None]).sum(
            dim=1, dtype=torch.uint8)
    return out


# ---------------------------------------------------------------- wrapper


class Launch:
    """One checked, prepared kernel launch: segment descriptors on the
    device, output allocated.  Calling it launches the kernel into
    ``out`` (again on each call), counts the launch and returns ``out``."""

    def __init__(self, name: str, args: tuple, out: torch.Tensor,
                 keep: tuple):
        self.name, self.out = name, out
        self._args = args
        self._keep = keep  # tensors the kernel reads, alive while this is

    def __call__(self) -> torch.Tensor:
        lib = library()
        fn = lib.gf_apply_k1_launch if self.name == "gf_apply_k1" else lib.gf_apply_k2_launch
        dev = self.out.device
        with torch.cuda.device(dev):
            rc = fn(*self._args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        LAUNCHES[self.name] += 1
        return self.out


def _checked_segments(n: int, segments) -> list[torch.Tensor]:
    segs = list(segments)
    if not 0 < len(segs) <= 65535:  # the launch grid's y extent
        raise ValueError(f"{len(segs)} input segments: want 1..65535")
    for s in segs:
        if not isinstance(s, torch.Tensor) or s.dtype != torch.uint8 or s.dim() != 2:
            raise ValueError("each segment must be a 2-D uint8 tensor")
        if s.shape[0] != n:
            raise ValueError(f"segment has {s.shape[0]} rows, matrix wants {n}")
        if s.device != segs[0].device:
            raise ValueError(f"segments on {s.device} and {segs[0].device}")
        if s.shape[1] > 1 and s.stride(1) != 1:
            raise ValueError("segment columns must be contiguous")
    return segs


def _checked_matrix(mat) -> np.ndarray:
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {mat.shape}")
    return mat


def prepare(mat: np.ndarray, segments, tables: torch.Tensor | None = None
            ) -> Launch:
    """Check the inputs of one K1/K2 launch on CUDA tensors and stage it
    (see ``gf_apply``) without launching."""
    mat = _checked_matrix(mat)
    return _prepare(mat, _checked_segments(mat.shape[1], segments), tables)


def _prepare(mat: np.ndarray, segs: list[torch.Tensor],
             tables: torch.Tensor | None) -> Launch:
    """``prepare`` for a matrix and segments already checked."""
    rows, n = mat.shape
    dev = segs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the GF kernels run on CUDA tensors, not {dev}")
    total = sum(s.shape[1] for s in segs)
    out = torch.empty((rows, total), dtype=torch.uint8, device=dev)
    if tables is None:
        tables = torch.from_numpy(nibble_tables(mat)).to(dev)
    if (tables.dtype != torch.uint8 or tuple(tables.shape) != (rows, n, 32)
            or not tables.is_contiguous() or tables.device != dev):
        raise ValueError(f"tables must be a contiguous [{rows}, {n}, 32] uint8 "
                         f"tensor on {dev}")
    desc, col = [], 0
    for s in segs:
        desc.append((s.data_ptr(), s.stride(0), s.shape[1], col))
        col += s.shape[1]
    desc_dev = torch.tensor(desc, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    max_len = max(s.shape[1] for s in segs)
    name = kernel_for(rows, n)
    layout = k2_layout(rows, n) if name == "gf_apply_k2" else ()
    args = (tables.data_ptr(), rows, n, *layout, desc_dev.data_ptr(), len(segs),
            max_len, out.data_ptr(), total)
    return Launch(name, args, out, (tables, desc_dev, *segs))


def gf_apply(mat: np.ndarray, segments, tables: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``mat [rows, n]`` applied to the column concatenation of
    ``segments`` (each a [n, L_s] uint8 tensor, rows may be strided):
    one [rows, sum L_s] output.

    CUDA tensors: ONE launch of K1 or K2 (``kernel_for``) over every
    segment, with no host-side concatenation or padding; ``tables`` is
    the matrix's ``nibble_tables`` on the device, built here when not
    given.  CPU tensors: ``apply_matrix_plain``."""
    mat = _checked_matrix(mat)
    rows, n = mat.shape
    segs = _checked_segments(n, segments)
    dev = segs[0].device
    if dev.type == "cpu":
        return apply_matrix_plain(mat, segs[0] if len(segs) == 1 else torch.cat(segs, 1))
    if rows == 0 or n == 0 or all(s.shape[1] == 0 for s in segs):
        total = sum(s.shape[1] for s in segs)
        return torch.zeros((rows, total), dtype=torch.uint8, device=dev)
    return _prepare(mat, segs, tables)()
