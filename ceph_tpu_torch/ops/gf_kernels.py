"""K1 and K2 — the GF(2^8) matrix apply on Hopper — and its plain version.

Counterpart of ceph_tpu/ops/pallas_gf.py.  The two CUDA kernels live in
csrc/gf_apply.cu and replace the two Pallas kernels one for one:

    gf_apply_k1  <- pallas_gf.py:184 ``_apply_kernel``          (rb == 1)
    gf_apply_k2  <- pallas_gf.py:202 ``_apply_kernel_blocked``  (rb > 1)

Both compute ``out[rows, L] = mat[rows, n] x in[n, L]`` over GF(2^8)
(polynomial 0x11d), bit-exact against gf/reference_codec.apply_matrix.
``kernel_for`` is the rule that picks one.  K1 looks the products up in
bit-field tables (3, 3 and 2 bits of a byte; 32 bytes per matrix entry,
``field_tables``) that hold the whole matrix in one block's shared
memory; ``k1_layout`` fits its tile to the launch.  K2 takes the fat
matrices: it runs the bitplane product on the tensor cores, against
``k2_operand`` (the GF(2) bitmatrix, packed and with its rows permuted
for the kernel's epilogue); ``k2_layout`` gives its grid and shared
memory.  ``device_operand`` is what either kernel reads for a matrix.

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
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..common.device import sm_count
from ..gf.matrix import matrix_to_bitmatrix
from ..gf.tables import GF_MUL_TABLE
from .nvcc import KernelError, NvccLibrary

#: accumulators a thread of K1 keeps: a K1 matrix has at most this many
#: rows (csrc: the largest MAXR instantiation)
MAX_ROWS = 16
#: table bytes per matrix entry: TA[8], TB[8] and TC[4] of ``field_tables``,
#: padded to 32
TABLE_BYTES_PER_ENTRY = 32
#: THE K1/K2 rule: a matrix goes to K1 when rows <= MAX_ROWS and its
#: tables take at most this many bytes of the block's shared memory;
#: every other matrix goes to K2.  RS(8,4) encode [4, 8] takes 1 KiB and
#: its decode [8, 8] 2 KiB; CLAY(8,4,d=11) repair [64, 176] would take
#: 352 KiB.
K1_MAX_TABLE_BYTES = 16 * 1024
#: K1's tiles, largest first: (threads a block, 16-byte vectors a
#: thread), 8192, 4096 and 2048 byte columns a block (``k1_layout``)
K1_TILES = ((256, 2), (256, 1), (128, 1))
#: input rows whose loads a K1 thread issues before any lookup: one trip
#: of its row loop (csrc K1_RING)
K1_RING = 8
#: segment descriptors a K1 launch takes by value in its kernel parameters
#: (csrc K1_PARAM_SEGS, within the 4 KiB of parameters every CUDA 12
#: toolkit takes); a launch over more copies them to a device array
K1_PARAM_SEGS = 120
#: K2's block tile (csrc K2_TILE_ROWS, K2_TILE_COLS): 8 output rows (64
#: bitmatrix rows) x 256 byte columns, 4 warps of 64 columns each
K2_TILE_ROWS = 8
K2_TILE_COLS = 256
#: input rows per shared-memory stage (csrc K2_STAGE_ROWS); the operand's
#: rows are padded to a multiple of it
K2_STAGE_ROWS = 64
#: bytes of one operand row in shared memory (csrc K2_OP_PITCH)
K2_OP_SMEM_PITCH = K2_STAGE_ROWS + 16
#: dynamic shared memory one block may use on Hopper (227 KiB)
SMEM_PER_BLOCK = 232448

KERNELS = ("gf_apply_k1", "gf_apply_k2")
#: launches per kernel since the last reset_launch_counts()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

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


class K1Layout(NamedTuple):
    """One K1 launch's shape (csrc gf_apply_k1_launch computes the grid
    from threads and vecs the same way)."""

    threads: int    # threads a block
    vecs: int       # 16-byte vectors of byte columns a thread
    col_tiles: int  # blocks along the longest segment

    @property
    def tile_cols(self) -> int:
        return 16 * self.threads * self.vecs


def k1_layout(max_len: int, nseg: int, sms: int) -> K1Layout:
    """K1's tile for a launch over ``nseg`` segments at most
    ``max_len`` long: the largest of K1_TILES that still gives at least
    two blocks an SM over the launch, else the smallest (2048 columns).
    A 4 MiB object's [8, 524288] stripe on 132 SMs: 256 blocks of 2048
    columns; the write batcher's packed [8, 33554432] flush: 4096 of
    8192."""
    for threads, vecs in K1_TILES:
        tiles = -(-max_len // (16 * threads * vecs))
        if tiles * nseg >= 2 * sms:
            break
    return K1Layout(threads, vecs, max(1, tiles))


class K2Layout(NamedTuple):
    """One K2 launch's shape (csrc gf_apply_k2_launch computes the same)."""

    row_tiles: int   # blocks along the rows: K2_TILE_ROWS output rows each
    col_tiles: int   # blocks along the longest segment: K2_TILE_COLS each
    op_pitch: int    # operand bytes per bitmatrix row: n padded to a stage
    smem_bytes: int  # dynamic shared memory per block: two stages


def k2_layout(rows: int, n: int, max_len: int) -> K2Layout:
    """The grid and shared memory of a K2 launch for a [rows, n] matrix
    over segments at most ``max_len`` long.  A stage holds the block's
    64 operand rows x K2_STAGE_ROWS bytes and K2_STAGE_ROWS input rows x
    K2_TILE_COLS columns; the block loops over the stages, so any n fits
    the same 26 KiB.  CLAY(8,4,d=11) repair [64, 176] x 65,536: 8 x 256
    blocks."""
    stage = 64 * K2_OP_SMEM_PITCH + K2_STAGE_ROWS * K2_TILE_COLS
    return K2Layout(-(-rows // K2_TILE_ROWS), -(-max_len // K2_TILE_COLS),
                    -(-n // K2_STAGE_ROWS) * K2_STAGE_ROWS, 2 * stage)


def k2_operand(mat: np.ndarray) -> np.ndarray:
    """K2's matrix operand, [64 * ceil(rows / 8), op_pitch] uint8.

    The GF(2) bitmatrix of ``mat`` (``matrix_to_bitmatrix``: row 8*i + b
    is bit b of output row i, column 8*j + x bit x of input row j), packed
    8 columns to a byte like the input (bit x of byte j), rows padded to a
    multiple of 8 output rows and n to a multiple of K2_STAGE_ROWS with
    zeros.  Within each 64-row tile the rows are permuted: tile row
    8*b + i holds bit b of output row i, so that a lane's mma accumulators
    are the 8 bits of one output row (csrc/gf_apply.cu, K2)."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    rows, n = mat.shape
    lay = k2_layout(rows, n, 0)
    bits = np.zeros((lay.row_tiles * K2_TILE_ROWS, 8, lay.op_pitch, 8), np.uint8)
    bits[:rows, :, :n] = matrix_to_bitmatrix(mat).reshape(rows, 8, n, 8)
    tiles = bits.reshape(lay.row_tiles, K2_TILE_ROWS, 8, lay.op_pitch, 8)
    tiles = tiles.transpose(0, 2, 1, 3, 4)  # [tile, bit b, row i, j, x]
    packed = np.packbits(tiles, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed.reshape(lay.row_tiles * 64, lay.op_pitch))


def operand_shape(rows: int, n: int) -> tuple[int, ...]:
    """Shape of ``device_operand`` for a [rows, n] matrix."""
    if kernel_for(rows, n) == "gf_apply_k1":
        return (rows, n, TABLE_BYTES_PER_ENTRY)
    lay = k2_layout(rows, n, 0)
    return (lay.row_tiles * 64, lay.op_pitch)


def device_operand(mat: np.ndarray) -> np.ndarray:
    """What the kernel ``kernel_for`` picks reads for ``mat``: K1's
    field tables or K2's packed bitmatrix."""
    if kernel_for(*np.shape(mat)) == "gf_apply_k1":
        return field_tables(mat)
    return k2_operand(mat)


#: the byte each entry of ``field_tables`` multiplies: fields of bits 0-2,
#: 3-5 and 6-7, then padding (c*0 = 0)
_FIELD_BYTES = np.zeros(TABLE_BYTES_PER_ENTRY, dtype=np.uint8)
_FIELD_BYTES[:8] = np.arange(8)
_FIELD_BYTES[8:16] = np.arange(8) << 3
_FIELD_BYTES[16:20] = np.arange(4) << 6


def field_tables(mat: np.ndarray) -> np.ndarray:
    """[rows, n, 32] uint8: entry (i, j) holds TA[x] = c*x (bytes 0-7),
    TB[x] = c*(x << 3) (bytes 8-15) and TC[x] = c*(x << 6) (bytes 16-19)
    for c = mat[i, j], then 12 zero bytes, so that
    c*b = TA[b & 7] ^ TB[(b >> 3) & 7] ^ TC[b >> 6]."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    return np.ascontiguousarray(GF_MUL_TABLE[mat[:, :, None], _FIELD_BYTES[None, None, :]])


# ---------------------------------------------------------------- build


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf_apply_k1_launch.argtypes = [p, i, i, p, p, i, ll, p, ll, i, i, p]
    lib.gf_apply_k1_launch.restype = i
    lib.gf_apply_k2_launch.argtypes = [p, i, i, i, p, i, ll, p, ll, p]
    lib.gf_apply_k2_launch.restype = i


#: csrc/gf_apply.cu, compiled by nvcc at first use (ops/nvcc.py)
LIBRARY = NvccLibrary("gf_apply.cu", _bind)


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled from the source on first use."""
    return LIBRARY.load()


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
    """One checked, prepared kernel launch: segment descriptors staged,
    output allocated.  Calling it launches the kernel into ``out`` (again
    on each call) on the current stream of the output's device, counts
    the launch and returns ``out``."""

    def __init__(self, name: str, args: tuple, out: torch.Tensor,
                 keep: tuple):
        self.name, self.out = name, out
        lib = library()
        self._fn = lib.gf_apply_k1_launch if name == "gf_apply_k1" else lib.gf_apply_k2_launch
        self._args = args
        self._index = out.device.index
        self._keep = keep  # what the kernel reads, alive while this is

    def __call__(self) -> torch.Tensor:
        if torch.cuda.current_device() == self._index:
            rc = self._fn(*self._args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(self._index):
                rc = self._fn(*self._args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise KernelError(f"{self.name} launch failed: CUDA error {rc}")
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
    segs = _checked_segments(mat.shape[1], segments)
    return _prepare(mat, segs, tables, _checked_out(mat, segs, None))


def _checked_out(mat: np.ndarray, segs: list[torch.Tensor],
                 out: torch.Tensor | None) -> torch.Tensor:
    """The [rows, sum L_s] output: `out` when given (checked), else new."""
    shape = (mat.shape[0], sum(s.shape[1] for s in segs))
    dev = segs[0].device
    if out is None:
        return torch.empty(shape, dtype=torch.uint8, device=dev)
    if (out.dtype != torch.uint8 or tuple(out.shape) != shape
            or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"out must be a contiguous {list(shape)} uint8 tensor "
                         f"on {dev}")
    return out


def _prepare(mat: np.ndarray, segs: list[torch.Tensor],
             tables: torch.Tensor | None, out: torch.Tensor) -> Launch:
    """``prepare`` for a matrix, segments and output already checked."""
    rows, n = mat.shape
    dev = segs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the GF kernels run on CUDA tensors, not {dev}")
    total = out.shape[1]
    name = kernel_for(rows, n)
    shape = operand_shape(rows, n)
    if tables is None:
        tables = torch.from_numpy(device_operand(mat)).to(dev)
    if (tables.dtype != torch.uint8 or tuple(tables.shape) != shape
            or not tables.is_contiguous() or tables.device != dev):
        raise ValueError(f"{name} wants its operand as a contiguous {list(shape)} "
                         f"uint8 tensor on {dev} (device_operand)")
    desc, col = [], 0
    for seg in segs:
        desc += (seg.data_ptr(), seg.stride(0), seg.shape[1], col)
        col += seg.shape[1]
    max_len = max(seg.shape[1] for seg in segs)
    if name == "gf_apply_k1" and len(segs) <= K1_PARAM_SEGS:
        # by value in the kernel's parameters: no copy to the card
        host_desc, dev_desc, dev_ptr = (ctypes.c_longlong * len(desc))(*desc), None, None
    else:
        host_desc = None
        dev_desc = torch.tensor(desc, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        dev_ptr = dev_desc.data_ptr()
    if name == "gf_apply_k1":
        lay = k1_layout(max_len, len(segs), sm_count(dev))
        args = (tables.data_ptr(), rows, n, host_desc, dev_ptr, len(segs), max_len,
                out.data_ptr(), total, lay.threads, lay.vecs)
    else:
        args = (tables.data_ptr(), rows, n, shape[1], dev_ptr, len(segs), max_len,
                out.data_ptr(), total)
    return Launch(name, args, out, (tables, host_desc, dev_desc, *segs))


def gf_apply(mat: np.ndarray, segments, tables: torch.Tensor | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``mat [rows, n]`` applied to the column concatenation of
    ``segments`` (each a [n, L_s] uint8 tensor, rows may be strided):
    one [rows, sum L_s] output, written into ``out`` when given (a pooled
    buffer, ops/device_pool.py).

    CUDA tensors: ONE launch of K1 or K2 (``kernel_for``) over every
    segment, with no host-side concatenation or padding; ``tables`` is
    the matrix's ``device_operand`` on the device (bitplane.TABLES caches
    it), built here when not given.  CPU tensors: ``apply_matrix_plain``."""
    mat = _checked_matrix(mat)
    rows, n = mat.shape
    segs = _checked_segments(n, segments)
    out = _checked_out(mat, segs, out)
    if segs[0].device.type == "cpu":
        return out.copy_(apply_matrix_plain(
            mat, segs[0] if len(segs) == 1 else torch.cat(segs, 1)))
    if rows == 0 or n == 0 or all(s.shape[1] == 0 for s in segs):
        return out.zero_()
    return _prepare(mat, segs, tables, out)()
