"""crush_ln — 16.44 fixed-point log2 used by straw2 draws.

The port's own copy of ceph_tpu/crush/ln_table.py.  Reference:
src/crush/mapper.c :: crush_ln and src/crush/crush_ln_table.h
(__RH_LH_tbl: pairs (2^56/index1, 2^48*log2(index1/256)) for even index1 in
[256, 512]; __LL_tbl: 2^48*log2(1 + i/2^15) for i in [0, 255]).

The tables are generated from those documented formulas exactly as the
reference package generates them, so both packages (and the C++ oracle,
whose header the reference emits from its copy) draw the same values.

Straw2 only ever calls crush_ln on u in [0, 0xffff], so the full 2^16
result table CRUSH_LN_TABLE is precomputed once.  The CUDA kernels take
these tables from here (ops/crush_kernels.py): the small RH_LH_TBL and
LL_TBL when they compute crush_ln, CRUSH_LN_TABLE when they look it up.
"""
from __future__ import annotations

import math

import numpy as np

_LOG2_SCALE_48 = float(1 << 48)


def _build_rh_lh() -> np.ndarray:
    """129 pairs for even index1 = 256..512: (RH, LH) as int64."""
    out = np.zeros(2 * 129, dtype=np.int64)
    for idx, index1 in enumerate(range(256, 514, 2)):
        # ceil: any downward error in RH makes x*RH >> 48 dip below 2^15 at
        # exact-division boundary x values, corrupting index2 by a full LL
        # span (1.1e-2 log2 error, non-monotonic); ceiling bounds the error
        # at one index2 step (4.4e-5) and keeps crush_ln strictly monotonic
        rh = -((-(1 << 56)) // index1)
        lh = round(_LOG2_SCALE_48 * math.log2(index1 / 256.0))
        out[2 * idx] = rh
        out[2 * idx + 1] = lh
    return out


def _build_ll() -> np.ndarray:
    """256 entries: 2^48 * log2(1 + i/2^15)."""
    return np.array(
        [round(_LOG2_SCALE_48 * math.log2(1.0 + i / 32768.0)) for i in range(256)],
        dtype=np.int64,
    )


RH_LH_TBL = _build_rh_lh()
LL_TBL = _build_ll()


def crush_ln_scalar(xin: int) -> int:
    """mapper.c :: crush_ln(xin) — returns log2(xin+1) in 16.44 fixed point."""
    x = (int(xin) + 1) & 0xFFFFFFFF
    iexpon = 15
    # normalize x into [2^15, 2^16)
    if not (x & 0x18000):
        bits = _clz32(x & 0x1FFFF) - 16
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1  # even, in [256, 512]
    rh = int(RH_LH_TBL[index1 - 256])      # ~ 2^56/index1
    lh = int(RH_LH_TBL[index1 + 1 - 256])  # ~ 2^48*log2(index1/256)
    xl64 = (x * rh) >> 48                  # ~ 2^15 + fractional byte
    index2 = xl64 & 0xFF
    ll = int(LL_TBL[index2])               # ~ 2^48*log2(1+index2/2^15)
    result = iexpon << (12 + 32)
    result += (lh + ll) >> (48 - 12 - 32)
    return result


def _clz32(x: int) -> int:
    if x == 0:
        return 32
    return 32 - x.bit_length()


def _build_ln_table() -> np.ndarray:
    """crush_ln over every possible straw2 input u in [0, 0xffff]."""
    return np.array([crush_ln_scalar(u) for u in range(0x10000)], dtype=np.int64)


CRUSH_LN_TABLE = _build_ln_table()

# straw2 constant: ln = crush_ln(u) - 0x1000000000000 (mapper.c ::
# bucket_straw2_choose), i.e. log2 of u/2^16 — negative for u < 0xffff.
LN_BIAS = 0x1000000000000
