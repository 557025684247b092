"""The port's magic reciprocals (ceph_tpu_torch/crush/magic_div.py) and
K3's draw by them, on the CPU.

- ``magic_for_divisor`` and ``magic_tables`` equal the reference's
  (ceph_tpu/crush/magic_div.py) on adversarial and seeded random
  divisors, and ``apply_magic == p // w`` on p at the edges of [0, 2^48]
  and 1000 seeded random p per divisor;
- an emulation, in numpy uint64, of the kernel's two-word product and
  shift on the joined 64-bit M (csrc/crush_straw2.cu ``magic_quotient``)
  gives ``p // w``;
- ``CompiledCrushMap``'s magic and a choose_args weight-set's equal
  ``straw2_magic`` of their weights;
- an emulation of K3's lane layout (T threads a lane, strided slots, the
  xor-shuffle reduction of (q, slot)) over chip_smoke.py's edge tables
  equals ``straw2_choose_plain`` at T = 1, 2, 8 and 32; and the host's
  choice of T.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import magic_div as ref_magic
from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map
from ceph_tpu_torch.crush import magic_div
from ceph_tpu_torch.crush.ln_table import LN_BIAS
from ceph_tpu_torch.crush.mapper import CompiledCrushMap
from ceph_tpu_torch.ops import crush_kernels as ck
from chip_smoke import K3_EDGE_CASES, k3_edge_case

ADVERSARIAL = [1, 2, 3, 7, 1 << 16, 0xFFFF, 0x10000, 0x10001, (1 << 31) - 1, 1 << 31,
               0xFFFFFFFF, 3 * (1 << 20) + 1]
RANDOM = np.random.default_rng(8).integers(1, 1 << 32, 40).tolist()
U64 = np.uint64


@pytest.mark.parametrize("w", ADVERSARIAL + RANDOM[:8])
def test_magic_for_divisor_matches_reference(w):
    assert magic_div.magic_for_divisor(w) == ref_magic.magic_for_divisor(w)


def test_magic_for_divisor_matches_reference_on_random_divisors():
    rng = np.random.default_rng(88)
    ws = rng.integers(1, 1 << 32, 500).tolist() + rng.integers(1, 1 << 17, 500).tolist()
    assert [magic_div.magic_for_divisor(w) for w in ws] == \
        [ref_magic.magic_for_divisor(w) for w in ws]


def test_magic_tables_match_reference():
    rng = np.random.default_rng(3)
    w = rng.integers(-5, 1 << 32, (3, 17, 37))
    w[w < 10] = 0
    w[0, 0, :len(ADVERSARIAL)] = ADVERSARIAL
    w[1, 2, :5] = -7
    got, want = magic_div.magic_tables(w), ref_magic.magic_tables(w)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _edge_ps(w: int) -> np.ndarray:
    rng = np.random.default_rng(w % 100003)
    edges = [0, 1, w - 1, w, w + 1, magic_div.P_MAX - 1, magic_div.P_MAX]
    ps = [p for p in edges if 0 <= p <= magic_div.P_MAX]
    return np.array(ps + rng.integers(0, magic_div.P_MAX + 1, 1000).tolist(), dtype=object)


@pytest.mark.parametrize("w", ADVERSARIAL + RANDOM[8:16])
def test_apply_magic_is_floor_division(w):
    M, k, a = magic_div.magic_for_divisor(w)
    ps = _edge_ps(w)
    np.testing.assert_array_equal(magic_div.apply_magic(ps, M, k, a), ps // w)
    t = magic_div.magic_tables(np.array([w]))
    np.testing.assert_array_equal(
        magic_div.straw2_draw_q_np(ps, t["m_limbs"][0].tolist(), int(t["k"][0]),
                                   int(t["a"][0])), ps // w)


def _umul64hi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """__umul64hi in uint64 numpy: the high word of a 64 x 64 product."""
    m32 = U64(0xFFFFFFFF)
    a_lo, a_hi, b_lo, b_hi = a & m32, a >> U64(32), b & m32, b >> U64(32)
    p0, p1, p2, p3 = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (p0 >> U64(32)) + (p1 & m32) + (p2 & m32)
    return p3 + (p1 >> U64(32)) + (p2 >> U64(32)) + (mid >> U64(32))


def _magic_quotient(pa: np.ndarray, m: np.ndarray, k: np.ndarray) -> np.ndarray:
    """csrc's magic_quotient: the product's two words, then the shift by
    k in [48, 96] (the high word alone once k >= 64)."""
    with np.errstate(over="ignore"):
        lo = pa * m
    hi = _umul64hi(pa, m)
    k = k.astype(U64)
    high = k >= U64(64)
    down = np.where(high, k - U64(64), U64(0))
    kk = np.where(high, U64(48), k)  # the other branch's shift, kept defined
    return np.where(high, hi >> down, (hi << (U64(64) - kk)) | (lo >> kk))


@pytest.mark.parametrize("w", ADVERSARIAL + RANDOM[16:24])
def test_kernel_two_word_product_on_joined_m(w):
    m, ka = ck.straw2_magic(np.array([w], np.int64))
    k, a = int(ka[0]) & 0xFF, (int(ka[0]) >> ck.KA_INC_SHIFT) & 1
    assert not ka[0] & ck.KA_NO_WEIGHT and 48 <= k <= 96
    assert (int(m[0]) & (2**64 - 1), k, a) == magic_div.magic_for_divisor(w)
    ps = _edge_ps(w)
    pa = np.array([p + a for p in ps], dtype=U64)
    q = _magic_quotient(pa, np.full(len(ps), m[0]).view(U64), np.full(len(ps), k))
    np.testing.assert_array_equal(q.astype(object), ps // w)


def test_join_limbs_and_no_weight_slots():
    w = np.array([[0, -3, 1, 0xFFFFFFFF], [1 << 31, 5, 0, 7]], np.int64)
    m, ka = ck.straw2_magic(w)
    assert m.dtype == np.int64 and ka.dtype == np.int32 and m.shape == ka.shape == w.shape
    t = magic_div.magic_tables(w)
    joined = sum(t["m_limbs"][..., j].astype(object) << (16 * j) for j in range(4))
    np.testing.assert_array_equal(m.view(U64).astype(object), joined)
    none = w <= 0
    np.testing.assert_array_equal((ka & ck.KA_NO_WEIGHT) != 0, none)
    assert (m[none] == 0).all() and ((ka[none] & 0xFF) == 48).all()


def _assert_magic_of(magic, weights: np.ndarray) -> None:
    m, ka = ck.straw2_magic(weights)
    np.testing.assert_array_equal(magic[0].numpy(), m)
    np.testing.assert_array_equal(magic[1].numpy(), ka)


def test_compiled_map_and_choose_args_magic():
    w = CrushWrapper(build_hierarchical_map(16, 4, racks=4))
    root = w.map.buckets[-1]
    rng = np.random.default_rng(5)
    noise = rng.uniform(0.5, 1.5, root.size)
    w.set_choose_args("bal", -1, [[int(v * e) for v, e in zip(root.weights, noise)],
                                  [0] + list(root.weights[1:]),
                                  [0xFFFFFFFF] * root.size])
    cm = w.compiled("cpu")
    _assert_magic_of((cm.magic_m, cm.magic_ka), cm.weights.numpy())
    cw = cm.choose_args_arrays("bal")
    assert cw.shape[0] == 3
    cmagic = cm.choose_args_magic("bal")
    assert cmagic[0].shape == (3 * cm.n_idx, cm.max_size)
    _assert_magic_of(cmagic, cw.reshape(-1, cm.max_size).numpy())
    assert cm.choose_args_magic("bal") is cmagic


def test_magic_of_a_1024_osd_map_builds_fast():
    """Built by distinct weight value: a 128-host x 8-OSD map's [129, 128]
    table has three values, so the build takes well under a millisecond
    (port_runs/magic_build_time.py); the cap here is a loose 20 ms, so a
    loaded host does not fail it."""
    import time

    weights = CompiledCrushMap(build_hierarchical_map(128, 8), device="cpu").weights.numpy()
    ck.straw2_magic(weights)
    t0 = time.perf_counter()
    for _ in range(20):
        ck.straw2_magic(weights)
    assert (time.perf_counter() - t0) / 20 < 0.02


def _k3_emulated(args, T: int) -> np.ndarray:
    """K3's lane layout in numpy: per slot q by the magic (no weight ->
    UINT64_MAX), thread t of a lane keeps the first strict minimum over
    slots t, t + T, ... (starting from (UINT64_MAX, t)), then the group's
    xor-shuffle reduction, the smaller q and on equal q the smaller slot
    winning; thread 0 writes the item."""
    items, weights, sizes, bidx, x, r, pos = args
    n_idx, S = items.shape
    P = weights.shape[0] // n_idx
    m, ka = ck.straw2_magic(weights.numpy())
    b = bidx.clamp(0, n_idx - 1).long()
    row = (pos.clamp(0, P - 1).long() * n_idx + b).numpy() if P > 1 else b.numpy()
    size = sizes[b].clamp(max=S).numpy()
    ln = ck.ln_scores_plain(x, items[b].contiguous(), r).numpy()
    kar = ka[row].astype(np.int64)
    pa = (LN_BIAS + ((kar >> ck.KA_INC_SHIFT) & 1) - ln).astype(U64)
    q = _magic_quotient(pa, m[row].view(U64), kar & 0xFF)
    walked = np.arange(S)[None, :] < size[:, None]
    q = np.where(walked & ((kar & ck.KA_NO_WEIGHT) == 0), q, ~U64(0))
    B = q.shape[0]
    n = -(-S // T)
    qp = np.full((B, n * T), ~U64(0), dtype=U64)
    qp[:, :S] = q
    per = qp.reshape(B, n, T)
    j = per.argmin(axis=1)  # the first minimum of each thread's slots
    best_q = np.take_along_axis(per, j[:, None, :], 1)[:, 0, :]
    best = j * T + np.arange(T)[None, :]
    off = T >> 1
    while off:
        partner = np.arange(T) ^ off
        oq, ob = best_q[:, partner], best[:, partner]
        take = (oq < best_q) | ((oq == best_q) & (ob < best))
        best_q, best = np.where(take, oq, best_q), np.where(take, ob, best)
        off >>= 1
    assert (best == best[:, :1]).all()  # every thread of a group agrees
    picked = items[b].numpy()[np.arange(B), best[:, 0]]
    return np.where(size > 0, picked, -0x7FFFFFFE), q


@pytest.mark.parametrize("T", [1, 2, 8, 32])
@pytest.mark.parametrize("case", [c for c in K3_EDGE_CASES if c[4] <= 8192],
                         ids=lambda c: c[0].replace(" ", "_"))
def test_k3_lane_layout_matches_plain(case, T):
    name, S, n_idx, P, B = case
    args = [torch.from_numpy(a) for a in k3_edge_case(S, n_idx, P, B, 17)]
    got, q = _k3_emulated(args, T)
    np.testing.assert_array_equal(got, ck.straw2_choose_plain(*args).numpy())
    assert torch.equal(ck.straw2_choose(*args), ck.straw2_choose_plain(*args))


def test_edge_tables_hold_ties_between_different_items():
    """The edge tables put equal minimum quotients on different slots of
    one lane, which only the reduction's slot order resolves."""
    name, S, n_idx, P, B = next(c for c in K3_EDGE_CASES if c[0] == "S128 B8192")
    args = [torch.from_numpy(a) for a in k3_edge_case(S, n_idx, P, B, 17)]
    _, q = _k3_emulated(args, 1)
    top = q.min(axis=1, keepdims=True)
    ties = ((q == top).sum(axis=1) > 1) & (top[:, 0] != ~U64(0))
    assert ties.sum() > 0


@pytest.mark.parametrize("B,S,want", [
    (5_592_405, 128, 1), (32768, 128, 8), (8192, 128, 32), (32768, 8, 8), (8192, 8, 8),
    (1, 128, 32), (31, 37, 32), (1, 1, 1), (4097, 8, 8), (300_000, 128, 1), (0, 5, 8),
])
def test_threads_per_lane(B, S, want):
    assert ck.threads_per_lane(B, S, 132) == want


def test_straw2_choose_checks_the_magic():
    args = [torch.from_numpy(a) for a in k3_edge_case(8, 9, 1, 64, 1)]
    m, ka = (torch.from_numpy(a) for a in ck.straw2_magic(args[1].numpy()))
    want = ck.straw2_choose_plain(*args)
    assert torch.equal(ck.straw2_choose(*args, magic=(m, ka), threads=4), want)
    with pytest.raises(ValueError):
        ck.straw2_choose(*args, magic=(m[:, :3].contiguous(), ka))
    with pytest.raises(ValueError):
        ck.straw2_choose(*args, magic=(m, ka.long()))
    with pytest.raises(ValueError):
        ck.straw2_choose(*args, threads=3)

