"""K3 — the batched straw2 choose on Hopper — its probe, and their plain
versions.

Counterpart of ceph_tpu/ops/pallas_crush.py and of the two Pallas probes
of perf_runs/.  The CUDA kernels live in csrc/crush_straw2.cu:

    crush_straw2_k3         <- pallas_crush.py:176 ``_score_kernel`` fused
                               with its caller's draw and argmax
                               (crush/batched.py:112 ``straw2_choose_b``)
    crush_ln_scores_k3      <- the same TPU kernel's function alone
    crush_ln_stream_{compute,table}
                            <- perf_runs/probe_flat.py:48 and
                               probe_gather.py:33

``straw2_choose`` is what the batched mapper calls for every straw2 draw:
for each lane it picks ``bucket_straw2_choose(bucket, x, r)``, the first
strict maximum of ``div64(crush_ln(hash3(x, item, r) & 0xffff) - 2^48,
weight)`` over the bucket's slots.  It is bound by integer operations
(the hash, crush_ln and the draw per slot), not by bytes.  The kernel
draws by each weight's exact magic reciprocal (``straw2_magic``, made
once per map by ``CompiledCrushMap``) instead of dividing, with
``threads_per_lane`` threads sharing a lane below a wave; the plain
version keeps the truncating divide.
``ln_scores`` computes crush_ln of every (x, item, r), the function the
TPU kernel computed; ``crush_ln_stream`` is the probe that times crush_ln's
two forms, computed from the small tables (``"compute"``) or looked up in
CRUSH_LN_TABLE (``"table"``).  K3 and ln_scores are built with the table
form only (``K3_LN_FORM`` in the source).

Each wrapper launches its kernel for CUDA tensors and raises if the build
or the launch fails; for CPU tensors it runs the plain PyTorch version of
the same function (``*_plain``).  There is no fallback from one to the
other.  ``LAUNCHES`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..common.device import sm_count
from ..crush.hash import crush_hash32_3
from ..crush.ln_table import CRUSH_LN_TABLE, LL_TBL, LN_BIAS, RH_LH_TBL
from ..crush.magic_div import join_limbs, magic_tables
from ..crush.types import ITEM_NONE
from .nvcc import KernelError, NvccLibrary

KERNELS = ("crush_straw2_k3", "crush_ln_scores_k3",
           "crush_ln_stream_compute", "crush_ln_stream_table")
#: launches per kernel since the last reset_launch_counts()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: magic tables ``straw2_choose`` built from its weights because the
#: caller gave none, since the last reset_launch_counts()
MAGIC_BUILDS = 0

#: crush_ln's two forms in the probe (csrc LnForm): computed from
#: RH_LH_TBL/LL_TBL in shared memory, or one load from CRUSH_LN_TABLE
LN_FORMS = {"compute": 0, "table": 1}

S64_MIN = -(1 << 63)
#: elements of [lanes, S] int64 the plain version works on at a time:
#: small enough on the CPU for its temporaries to stay in cache, bounded on
#: the card so a 10M-lane call needs no [10M, 128] intermediates
_PLAIN_CHUNK = {"cpu": 1 << 19, "cuda": 1 << 25}

#: the packed magic word's fields (csrc KA_*): k in bits 0-7, a in bit 8,
#: bit 9 set for a slot with no weight
KA_INC_SHIFT = 8
KA_NO_WEIGHT = 1 << 9
#: resident threads per SM on Hopper, and K3's most threads per lane
THREADS_PER_SM = 2048
MAX_THREADS_PER_LANE = 32


def reset_launch_counts() -> None:
    global MAGIC_BUILDS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    MAGIC_BUILDS = 0


# ---------------------------------------------------------------- build


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crush_straw2_choose_launch.argtypes = [
        p, p, p, p, i, i, i, p, p, p, p, ll, i, p, p, p, p, p]
    lib.crush_straw2_choose_launch.restype = i
    lib.crush_ln_scores_launch.argtypes = [p, p, p, i, i, p, p, p, p, p]
    lib.crush_ln_scores_launch.restype = i
    lib.crush_ln_stream_launch.argtypes = [i, p, ll, p, p, p, p, p]
    lib.crush_ln_stream_launch.restype = i


#: csrc/crush_straw2.cu, compiled by nvcc at first use (ops/nvcc.py)
LIBRARY = NvccLibrary("crush_straw2.cu", _bind)


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled from the source on first use."""
    return LIBRARY.load()


_TABLES: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def ln_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(RH_LH_TBL, LL_TBL, CRUSH_LN_TABLE) as int64 tensors on `device`,
    made once per device."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                             for t in (RH_LH_TBL, LL_TBL, CRUSH_LN_TABLE))
    return _TABLES[key]


def straw2_magic(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K3's draw constants for a [..., S] int64 weight table: M as int64
    bits and the packed (k, a) word as int32, both shaped like `weights`
    (crush/magic_div.py).  A weight <= 0 gets M = 0 and KA_NO_WEIGHT."""
    w = np.asarray(weights, dtype=np.int64)
    t = magic_tables(w)
    ka = t["k"] | (t["a"] << KA_INC_SHIFT)
    ka = np.where(w > 0, ka, ka | KA_NO_WEIGHT).astype(np.int32)
    return join_limbs(t["m_limbs"]), ka


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def threads_per_lane(B: int, S: int, sms: int) -> int:
    """K3's threads per lane: the power of two, from 1 to
    min(32, S rounded up to a power of two), that brings B lanes closest
    to one wave of resident threads (sms x 2048) without passing it; 1
    once B alone fills the wave."""
    cap = min(MAX_THREADS_PER_LANE, 1 << max(S - 1, 0).bit_length())
    return max(1, min(cap, _pow2_floor(sms * THREADS_PER_SM // max(B, 1))))


def _launch(name: str, fn, *args) -> None:
    dev = torch.cuda.current_device()
    rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# ------------------------------------------------------------ plain versions


def div64_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C-style truncating signed division (div64_s64); ``//`` floors, and
    the draws are negative."""
    return torch.div(a, b, rounding_mode="trunc")


def _lane_step(device: torch.device, S: int) -> int:
    return max(1, _PLAIN_CHUNK[device.type] // max(S, 1))


def ln_scores_plain(x: torch.Tensor, items: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[B, S] int64 crush_ln(hash3(x, item, r) & 0xffff), in plain PyTorch
    on the tensors' device: the masked-int64 hash and a CRUSH_LN_TABLE
    gather."""
    B, S = items.shape
    table = ln_tables(items.device)[2]
    out = torch.empty((B, S), dtype=torch.int64, device=items.device)
    step = _lane_step(items.device, S)
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        u = crush_hash32_3(x[lo:hi, None], items[lo:hi], r[lo:hi, None]) & 0xFFFF
        out[lo:hi] = table[u]
    return out


def straw2_choose_plain(items_tbl: torch.Tensor, weights_tbl: torch.Tensor,
                        sizes: torch.Tensor, bucket_idx: torch.Tensor,
                        x: torch.Tensor, r: torch.Tensor,
                        position: torch.Tensor) -> torch.Tensor:
    """``straw2_choose`` in plain PyTorch: per lane, the [S] row of items
    and weights, every slot's draw, S64_MIN for slots with no weight or
    past the bucket's size, and the first maximum (torch.argmax)."""
    n_idx, S = items_tbl.shape
    P = weights_tbl.shape[0] // n_idx
    B = bucket_idx.shape[0]
    out = torch.full((B,), ITEM_NONE, dtype=torch.int32, device=items_tbl.device)
    if S == 0:
        return out
    slot = torch.arange(S, device=items_tbl.device)
    step = _lane_step(items_tbl.device, S)
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        bidx = bucket_idx[lo:hi].clamp(0, n_idx - 1).long()
        items = items_tbl[bidx]
        pos = position[lo:hi].clamp(0, P - 1).long()
        weights = weights_tbl[pos * n_idx + bidx]
        size = sizes[bidx]
        ln = ln_scores_plain(x[lo:hi], items, r[lo:hi]) - LN_BIAS
        draw = div64_trunc(ln, weights.clamp(min=1))
        valid = (slot[None, :] < size[:, None]) & (weights > 0)
        draw = torch.where(valid, draw, S64_MIN)
        picked = items.gather(1, draw.argmax(dim=1, keepdim=True))[:, 0]
        out[lo:hi] = torch.where(size > 0, picked, ITEM_NONE)
    return out


def crush_ln_stream_plain(u: torch.Tensor) -> torch.Tensor:
    """[N] int64 CRUSH_LN_TABLE[u & 0xffff]."""
    return ln_tables(u.device)[2][(u & 0xFFFF).long()]


# ---------------------------------------------------------------- wrappers


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: want a {ndim}-D {dtype} tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def straw2_choose(items_tbl: torch.Tensor, weights_tbl: torch.Tensor,
                  sizes: torch.Tensor, bucket_idx: torch.Tensor,
                  x: torch.Tensor, r: torch.Tensor,
                  position: torch.Tensor, *,
                  magic: tuple[torch.Tensor, torch.Tensor] | None = None,
                  threads: int | None = None) -> torch.Tensor:
    """bucket_straw2_choose for each of B lanes: [B] int32 chosen items.

    items_tbl [n_idx, S] int32 and sizes [n_idx] int32 are the compiled
    map's buckets (row i is bucket -1-i, padded with ITEM_NONE);
    weights_tbl [P * n_idx, S] int64 holds P weight rows per bucket (P > 1
    only with a choose_args weight-set: lane j reads row
    min(position[j], P-1) * n_idx + bucket).  bucket_idx, x, r and position
    are [B] int32.  An empty bucket gives ITEM_NONE.

    `magic` is ``straw2_magic(weights_tbl)`` on the tensors' device
    ([P * n_idx, S] int64 and int32), which the mapper builds once per map;
    without it a CUDA call builds it here and counts it in MAGIC_BUILDS.
    `threads` overrides ``threads_per_lane`` (a power of two, 1 to 32).

    CUDA tensors: one K3 launch.  CPU tensors: ``straw2_choose_plain``."""
    global MAGIC_BUILDS
    dev = items_tbl.device
    _check("items_tbl", items_tbl, torch.int32, 2, dev)
    n_idx, S = items_tbl.shape
    _check("weights_tbl", weights_tbl, torch.int64, 2, dev)
    if n_idx == 0 or weights_tbl.shape[1] != S or weights_tbl.shape[0] % n_idx:
        raise ValueError(f"weights_tbl {tuple(weights_tbl.shape)} does not fit "
                         f"items_tbl {tuple(items_tbl.shape)}")
    _check("sizes", sizes, torch.int32, 1, dev)
    if sizes.shape[0] != n_idx:
        raise ValueError(f"sizes has {sizes.shape[0]} buckets, items_tbl {n_idx}")
    for name, t in (("bucket_idx", bucket_idx), ("x", x), ("r", r), ("position", position)):
        _check(name, t, torch.int32, 1, dev)
    B = bucket_idx.shape[0]
    if any(t.shape[0] != B for t in (x, r, position)):
        raise ValueError(f"x, r and position must have bucket_idx's {B} lanes")
    if magic is not None:
        for name, t, dtype in (("magic M", magic[0], torch.int64),
                               ("magic ka", magic[1], torch.int32)):
            _check(name, t, dtype, 2, dev)
            if t.shape != weights_tbl.shape:
                raise ValueError(f"{name} {tuple(t.shape)} does not fit weights_tbl "
                                 f"{tuple(weights_tbl.shape)}")
    if threads is not None and (threads not in (1, 2, 4, 8, 16, 32)):
        raise ValueError(f"threads {threads}: want a power of two from 1 to 32")
    if dev.type == "cpu":
        return straw2_choose_plain(items_tbl, weights_tbl, sizes, bucket_idx, x, r, position)
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if magic is None:
        magic = tuple(torch.from_numpy(a).to(dev)
                      for a in straw2_magic(weights_tbl.cpu().numpy()))
        MAGIC_BUILDS += 1
    T = threads or threads_per_lane(B, S, sm_count(dev))
    rh_lh, ll, full = ln_tables(dev)
    with torch.cuda.device(dev):
        _launch("crush_straw2_k3", library().crush_straw2_choose_launch,
                items_tbl.data_ptr(), magic[0].data_ptr(), magic[1].data_ptr(),
                sizes.data_ptr(), n_idx, S, weights_tbl.shape[0] // n_idx,
                bucket_idx.data_ptr(), x.data_ptr(), r.data_ptr(), position.data_ptr(),
                B, T, rh_lh.data_ptr(), ll.data_ptr(), full.data_ptr(), out.data_ptr())
    return out


def ln_scores(x: torch.Tensor, items: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[B, S] int64 crush_ln(hash3(x[j], items[j, s], r[j]) & 0xffff): the
    TPU kernel's function (its hi and lo planes joined).  x and r [B]
    int32, items [B, S] int32.

    CUDA tensors: one launch of K3's ln_scores kernel.  CPU tensors:
    ``ln_scores_plain``."""
    dev = items.device
    _check("items", items, torch.int32, 2, dev)
    B, S = items.shape
    for name, t in (("x", x), ("r", r)):
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} lanes, items {B}")
    if dev.type == "cpu":
        return ln_scores_plain(x, items, r)
    if B * S >= 1 << 30:
        raise ValueError(f"ln_scores takes under 2^30 elements, got [{B}, {S}]")
    out = torch.empty((B, S), dtype=torch.int64, device=dev)
    if B * S == 0:
        return out
    rh_lh, ll, full = ln_tables(dev)
    with torch.cuda.device(dev):
        _launch("crush_ln_scores_k3", library().crush_ln_scores_launch,
                x.data_ptr(), items.data_ptr(), r.data_ptr(), B, S,
                rh_lh.data_ptr(), ll.data_ptr(), full.data_ptr(), out.data_ptr())
    return out


def crush_ln_stream(u: torch.Tensor, form: str) -> torch.Tensor:
    """[N] int64 crush_ln(u & 0xffff) of an [N] int32 stream, by the probe
    kernel in `form` ("compute" or "table").  CPU tensors:
    ``crush_ln_stream_plain``."""
    if form not in LN_FORMS:
        raise ValueError(f"form {form!r}: want one of {sorted(LN_FORMS)}")
    _check("u", u, torch.int32, 1, u.device)
    if u.device.type == "cpu":
        return crush_ln_stream_plain(u)
    out = torch.empty(u.shape, dtype=torch.int64, device=u.device)
    if u.numel() == 0:
        return out
    rh_lh, ll, full = ln_tables(u.device)
    with torch.cuda.device(u.device):
        _launch(f"crush_ln_stream_{form}", library().crush_ln_stream_launch,
                LN_FORMS[form], u.data_ptr(), u.numel(), rh_lh.data_ptr(), ll.data_ptr(),
                full.data_ptr(), out.data_ptr())
    return out
