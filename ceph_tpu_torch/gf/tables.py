"""GF(2^8) arithmetic tables and scalar ops.

The port's own copy of ceph_tpu/gf/tables.py (the port imports nothing of
ceph_tpu): the role gf-complete plays in the reference (reference:
src/erasure-code/jerasure/gf-complete :: gf_w8).  Plain numpy tables for
matrix construction, host-side inversion, the numpy reference codec, and
the split-nibble tables the CUDA kernels look up (ops/gf_kernels.py).

Field: GF(2^8) with primitive polynomial 0x11D (x^8+x^4+x^3+x^2+1), the
default used by jerasure/gf-complete for w=8 (reference:
src/erasure-code/jerasure/gf-complete/src/gf_w8.c) and by ISA-L — so matrix
entries and parity bytes are comparable across all of them.
"""
from __future__ import annotations

import numpy as np

GF_POLY = 0x11D
GF_BITS = 8
GF_SIZE = 1 << GF_BITS  # 256


def _build_tables():
    exp = np.zeros(2 * GF_SIZE, dtype=np.int32)  # doubled to skip mod in mul
    log = np.zeros(GF_SIZE, dtype=np.int32)
    x = 1
    for i in range(GF_SIZE - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(GF_SIZE - 1, 2 * GF_SIZE):
        exp[i] = exp[i - (GF_SIZE - 1)]
    log[0] = 0  # undefined; callers must not use log[0]
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 multiplication table (useful for vectorized numpy reference
# and exhaustive bit-exactness sweeps, SURVEY.md §7 "hard parts").
_a = np.arange(256)
GF_MUL_TABLE = np.where(
    (_a[:, None] == 0) | (_a[None, :] == 0),
    0,
    GF_EXP[(GF_LOG[_a[:, None]] + GF_LOG[_a[None, :]]) % 255],
).astype(np.uint8)
del _a

GF_INV_TABLE = np.zeros(256, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[(255 - GF_LOG[np.arange(1, 256)]) % 255]


def gf_mul(a: int, b: int) -> int:
    """galois_single_multiply(a, b, 8) (reference:
    src/erasure-code/jerasure/jerasure/src/galois.c :: galois_single_multiply)."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_div(a: int, b: int) -> int:
    """galois_single_divide(a, b, 8)."""
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_INV_TABLE[a])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_mul_vec(a, b):
    """Elementwise GF(2^8) product of uint8 arrays via the full table."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return GF_MUL_TABLE[a, b]


def gf_matmul(A, B):
    """GF(2^8) matrix product of uint8 matrices (host-side, numpy).

    Used for matrix inversion checks and the numpy reference codec — the
    MemStore-analog oracle of SURVEY.md §4 ("NumPy reference codec").
    """
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    # products: [i, j, l] = A[i, l] * B[l, j]
    prod = GF_MUL_TABLE[A[:, None, :], B.T[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=2)

