"""CRUSH rjenkins1 hash over tensors — bit-exact uint32 semantics.

The port's counterpart of ceph_tpu/crush/hash.py.  Reference:
src/crush/hash.c :: crush_hash32_rjenkins1{_2,_3,_4} — Robert Jenkins'
32-bit integer mix, all arithmetic mod 2^32 (wrapping subtraction, XOR,
shifts).

torch has no add, subtract or shift for uint32, so the tensor functions
compute in int64 on values held in [0, 2^32): each subtraction and left
shift is masked back with ``& 0xFFFFFFFF`` (a right shift or an XOR of
such values stays in range).  Operands are first reduced to their uint32
value, so negative bucket ids hash as their two's-complement bits, as in
C.  The results are int64 tensors in [0, 2^32).  The numpy twins run the
same mix on uint32 arrays, which wrap natively.
"""
from __future__ import annotations

import numpy as np
import torch

CRUSH_HASH_SEED = 1315423911
M32 = 0xFFFFFFFF


def _mix(a, b, c):
    """hash.c :: crush_hashmix(a, b, c) on values in [0, 2^32)."""
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def _u32(x) -> torch.Tensor:
    """The uint32 value of each element, as int64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.int64))
    return x.to(torch.int64) & M32


def crush_hash32(a) -> torch.Tensor:
    """hash.c :: crush_hash32_rjenkins1."""
    a = _u32(a)
    hash_ = CRUSH_HASH_SEED ^ a
    b, x, y = a, 231232, 1232
    b, x, hash_ = _mix(b, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    return hash_


def crush_hash32_2(a, b) -> torch.Tensor:
    """hash.c :: crush_hash32_rjenkins1_2 (is_out, pg -> pps seeding)."""
    a, b = _u32(a), _u32(b)
    hash_ = CRUSH_HASH_SEED ^ a ^ b
    x, y = 231232, 1232
    a, b, hash_ = _mix(a, b, hash_)
    x, a, hash_ = _mix(x, a, hash_)
    b, y, hash_ = _mix(b, y, hash_)
    return hash_


def crush_hash32_3(a, b, c) -> torch.Tensor:
    """hash.c :: crush_hash32_rjenkins1_3 — the straw2 draw hash."""
    a, b, c = _u32(a), _u32(b), _u32(c)
    hash_ = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = 231232, 1232
    a, b, hash_ = _mix(a, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    b, x, hash_ = _mix(b, x, hash_)
    y, c, hash_ = _mix(y, c, hash_)
    return hash_


def crush_hash32_4(a, b, c, d) -> torch.Tensor:
    """hash.c :: crush_hash32_rjenkins1_4 (chooseleaf / descend_once salt)."""
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    hash_ = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = 231232, 1232
    a, b, hash_ = _mix(a, b, hash_)
    c, d, hash_ = _mix(c, d, hash_)
    a, x, hash_ = _mix(a, x, hash_)
    y, b, hash_ = _mix(y, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, d, hash_ = _mix(y, d, hash_)
    return hash_


def crush_hash32_2_np(a, b) -> np.ndarray:
    """Numpy twin of crush_hash32_2 (pg -> pps seeding, primary affinity)."""
    with np.errstate(over="ignore"):
        a = np.asarray(a, dtype=np.uint32)
        b = np.asarray(b, dtype=np.uint32)
        hash_ = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
        x = np.uint32(231232)
        y = np.uint32(1232)
        a, b, hash_ = _mix(a, b, hash_)
        x, a, hash_ = _mix(x, a, hash_)
        b, y, hash_ = _mix(b, y, hash_)
        return hash_


def crush_hash32_3_np(a, b, c) -> np.ndarray:
    """Numpy twin of crush_hash32_3 (host-side golden generator)."""
    with np.errstate(over="ignore"):
        a = np.asarray(a, dtype=np.uint32)
        b = np.asarray(b, dtype=np.uint32)
        c = np.asarray(c, dtype=np.uint32)
        hash_ = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
        x = np.uint32(231232)
        y = np.uint32(1232)
        a, b, hash_ = _mix(a, b, hash_)
        c, x, hash_ = _mix(c, x, hash_)
        y, a, hash_ = _mix(y, a, hash_)
        b, x, hash_ = _mix(b, x, hash_)
        y, c, hash_ = _mix(y, c, hash_)
        return hash_
