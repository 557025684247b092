"""Exact division-by-invariant-integer magic for the straw2 draw.

The port's copy of ceph_tpu/crush/magic_div.py (numpy and Python ints
only).  The straw2 draw is ``div64_s64(crush_ln(u) - 2**48, weight)``
(reference: src/crush/mapper.c :: bucket_straw2_choose).  CRUSH weights
are map constants, not data: every (bucket, slot) divisor is known on
the host when the map compiles.  So each divisor ``w`` gets a magic
multiplier ``(M, k, a)`` with

    floor(p / w) == ((p + a) * M) >> k      for all 0 <= p <= P_MAX

(Granlund & Montgomery; Hacker's Delight 10-9/10-10: the round-up magic
``a=0`` or the round-down-with-increment ``a=1`` variant always exists at
modest k), and K3 (csrc/crush_straw2.cu) needs one 64x64->128-bit
multiply and a shift per slot instead of a 64-bit divide.

``p`` is the negated draw numerator: ln = crush_ln(u) - 2**48 is in
[-2**48, 0], so p = 2**48 - crush_ln(u) is in [0, 2**48] and
draw = -floor(p / w).  The first maximum over draws (mapper.c's strict
``>`` scan) is the first minimum over quotients.

The reference keeps M as four 16-bit limbs for a TPU's int32 lanes
(``magic_tables``, ``straw2_draw_q_np``); ``join_limbs`` gives the one
64-bit word the card reads.
"""
from __future__ import annotations

import numpy as np

# p = 2**48 - crush_ln(u) <= 2**48 inclusive
P_MAX = 1 << 48

# Magic multipliers fit 4 x 16-bit limbs for every divisor (M ~ 2**49..
# 2**51 regardless of w — see magic_for_divisor's postcondition check)
M_LIMBS = 4
# (p + a) fits 4 x 16-bit limbs (p <= 2**48, so limb 3 is 0 or 1)
P_LIMBS = 4
# full product fits 7 limbs (2**48 * 2**51 < 2**112)
PROD_LIMBS = 7


def magic_for_divisor(w: int) -> tuple[int, int, int]:
    """(M, k, a) with ((p + a) * M) >> k == p // w for all 0 <= p <= P_MAX.

    Proof obligations (checked, not assumed):
    - round-up (a=0): M = 2**k // w + 1, e = M*w - 2**k in (0, w];
      exact iff P_MAX * e < 2**k  (then the quotient error term
      p*e/2**k < 1 can never carry the floor past the true quotient).
    - round-down + increment (a=1): M = 2**k // w, e = 2**k - M*w in
      [0, w); exact iff (P_MAX + 1) * e <= 2**k.

    Both need e >= 1, so no k below 49 passes either test: the search
    starts there, with the same first passing k as a search from
    w.bit_length().
    """
    if w <= 0:
        raise ValueError(f"divisor must be positive, got {w}")
    if w & (w - 1) == 0:
        # power of two: p // w == p >> lg(w), expressed at k=48 so the
        # kernel's fixed shift window applies
        return 1 << (48 - (w.bit_length() - 1)), 48, 0
    k = max(w.bit_length(), 49)
    while True:
        m_up = (1 << k) // w + 1
        e_up = m_up * w - (1 << k)
        if P_MAX * e_up < (1 << k):
            M, a = m_up, 0
            break
        m_dn = (1 << k) // w
        e_dn = (1 << k) - m_dn * w
        # e_dn == 0 would make this floor((p+1)/w) — only e_dn >= 1 keeps
        # the error term strictly inside the (r, r+1] bracket
        if m_dn > 0 and e_dn > 0 and (P_MAX + 1) * e_dn <= (1 << k):
            M, a = m_dn, 1
            break
        k += 1
    # postconditions the kernel layout depends on
    if M.bit_length() > 16 * M_LIMBS:
        raise AssertionError(f"magic for w={w} needs {M.bit_length()} bits")
    if not (48 <= k <= 16 * (PROD_LIMBS - 1)):
        raise AssertionError(f"magic for w={w} has shift {k}, outside [48, 96]")
    return M, k, a


def apply_magic(p, M: int, k: int, a: int):
    """Bignum/numpy-object golden: ((p + a) * M) >> k."""
    p = np.asarray(p, dtype=object)
    return (p + a) * M >> k


def magic_tables(weights: np.ndarray):
    """Vectorized build for a [..., S] int64 weight array, one
    ``magic_for_divisor`` per distinct positive weight.

    Returns dict of int32 arrays, all shaped like ``weights`` plus a limb
    axis where noted:
      m_limbs  [..., S, M_LIMBS]  16-bit limbs of M
      k        [..., S]           shift
      a        [..., S]           increment flag
    Zero/negative weights get an all-zero magic with k = 48 (their slots
    are masked invalid by the caller before the argmin).
    """
    w = np.asarray(weights, dtype=np.int64)
    flat = w.reshape(-1)
    m_limbs = np.zeros((flat.size, M_LIMBS), np.int32)
    ks = np.full(flat.size, 48, np.int32)
    aa = np.zeros(flat.size, np.int32)
    pos = flat > 0
    values, inverse = np.unique(flat[pos], return_inverse=True)
    if values.size:
        magic = [magic_for_divisor(v) for v in values.tolist()]
        u_limbs = np.array([[(M >> (16 * j)) & 0xFFFF for j in range(M_LIMBS)]
                            for M, _, _ in magic], dtype=np.int32)
        m_limbs[pos] = u_limbs[inverse]
        ks[pos] = np.array([k for _, k, _ in magic], np.int32)[inverse]
        aa[pos] = np.array([a for _, _, a in magic], np.int32)[inverse]
    shape = w.shape
    return {
        "m_limbs": m_limbs.reshape(shape + (M_LIMBS,)),
        "k": ks.reshape(shape),
        "a": aa.reshape(shape),
    }


def join_limbs(m_limbs: np.ndarray) -> np.ndarray:
    """M from its [..., M_LIMBS] 16-bit limbs as one 64-bit word, stored
    as int64 bits (the form K3 reads)."""
    limbs = np.asarray(m_limbs).astype(np.uint64)
    m = np.zeros(limbs.shape[:-1], np.uint64)
    for j in range(M_LIMBS):
        m |= limbs[..., j] << np.uint64(16 * j)
    return m.view(np.int64)


def straw2_draw_q_np(p: np.ndarray, m_limbs, k, a) -> np.ndarray:
    """Numpy-int64-free golden of the reference's limb pipeline: split p
    into 16-bit limbs, multiply by the magic limbs with base-2**16 carry
    propagation, variable-shift the 7-limb product by k, in Python ints.
    """
    p = np.asarray(p, dtype=object)
    m_limbs = np.asarray(m_limbs, dtype=object)
    k = np.asarray(k, dtype=object)
    a = np.asarray(a, dtype=object)
    pa = p + a
    pl = [(pa >> (16 * j)) & 0xFFFF for j in range(P_LIMBS)]
    # column accumulation: col[c] = sum_{i+j==c} pl[i]*ml[j]
    cols = [np.zeros_like(p) for _ in range(PROD_LIMBS + 1)]
    for i in range(P_LIMBS):
        for j in range(M_LIMBS):
            cols[i + j] = cols[i + j] + pl[i] * m_limbs[..., j]
    # carry propagate to clean 16-bit limbs
    limbs = []
    carry = np.zeros_like(p)
    for c in range(PROD_LIMBS + 1):
        v = cols[c] + carry
        limbs.append(v & 0xFFFF)
        carry = v >> 16
    # variable shift: quotient = product >> k, k in [48, 96]
    total = np.zeros_like(p)
    for c, l in enumerate(limbs):
        total = total + (l << (16 * c))
    return total >> k


__all__ = [
    "P_MAX",
    "M_LIMBS",
    "P_LIMBS",
    "PROD_LIMBS",
    "magic_for_divisor",
    "apply_magic",
    "magic_tables",
    "join_limbs",
    "straw2_draw_q_np",
]
