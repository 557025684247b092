"""Pure-numpy RS codec — the in-process fake of SURVEY.md §4 ring 3.

Plays the role MemStore plays for the reference's OSD tests (reference:
src/os/memstore/MemStore.cc): a slow, obviously-correct implementation that
unit tests and the CUDA kernels are both checked against.  The port's own
copy of ceph_tpu/gf/reference_codec.py; CLAY's host-side repair-matrix
build uses it too.
"""
from __future__ import annotations

import numpy as np

from .matrix import decode_matrix_for, systematic_generator
from .tables import GF_MUL_TABLE


def encode_chunks(coding: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Parity chunks for data chunks.

    data: [k, chunk_bytes] uint8 -> returns [m, chunk_bytes] uint8.
    Equivalent to jerasure.c :: jerasure_matrix_encode at w=8.
    """
    coding = np.asarray(coding, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    m, k = coding.shape
    assert data.shape[0] == k, (data.shape, k)
    # parity[i] = XOR_j coding[i,j] * data[j]
    prod = GF_MUL_TABLE[coding[:, :, None], data[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def apply_matrix(mat: np.ndarray, chunks: np.ndarray) -> np.ndarray:
    """Generic GF(2^8) matrix-times-chunks (rows x n) @ [n, chunk_bytes]."""
    mat = np.asarray(mat, dtype=np.uint8)
    chunks = np.asarray(chunks, dtype=np.uint8)
    prod = GF_MUL_TABLE[mat[:, :, None], chunks[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def decode_chunks(
    coding: np.ndarray,
    k: int,
    available: dict[int, np.ndarray],
    want: list[int] | None = None,
) -> dict[int, np.ndarray]:
    """Reconstruct wanted shards from >= k available shards.

    Mirrors jerasure_matrix_decode's erasures handling: build the decode
    matrix from the first k surviving generator rows, recover data, then
    re-encode any wanted parity shards.
    """
    m = coding.shape[0]
    gen = systematic_generator(coding)
    avail_rows = sorted(available.keys())
    dm = decode_matrix_for(gen, k, avail_rows)
    sub = np.stack([available[r] for r in avail_rows[:k]])
    data = apply_matrix(dm, sub)
    if want is None:
        want = list(range(k + m))
    out: dict[int, np.ndarray] = {}
    for s in want:
        if s in available:
            out[s] = np.asarray(available[s], dtype=np.uint8)
        elif s < k:
            out[s] = data[s]
        else:
            out[s] = apply_matrix(coding[s - k : s - k + 1], data)[0]
    return out
