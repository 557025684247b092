"""The port's CUDA kernels on the card against their plain PyTorch
versions, byte for byte, at edge-case shapes: K1 at each tile k1_layout
chooses (lengths one below, at and one past a tile boundary), rows 1 to
16 and n up to the K1/K2 rule's edge, with its segment descriptors by
value and from a device array (at K1_PARAM_SEGS and one past it); K1 and
K2 (ragged lengths,
unaligned and strided rows, several segments in one launch, 333 of them
for K2; K2 at rows around its 8-row tiles, n around its 4-row k-steps
and 64-row stages, L one short of and one past its 64-column warp
tiles and 256-column block tiles); K3 (ragged lane counts, bucket
widths 1 to 128, empty buckets, weight-set positions, and chip_smoke.py's
edge tables at 1, 2, 8 and 32 threads a lane) and both forms of
the crush_ln probe over every u; the batch mapper on the card; the
OSDMap's map_pool against device="cpu" and the scalar mapping (pg_num
not a power of two, EC pools wider than the hosts); the
device pool's ordering of a released buffer behind the kernel that still
reads it, stream_encode from pinned staging at ragged batch sizes, and
the write and read batchers on the card.  Marked ``cuda``: each test
that needs a card skips without one.  On a GPU machine (the
JAX package is not needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from ceph_tpu_torch.common.device import sm_count
from ceph_tpu_torch.gf.matrix import cauchy_good_coding_matrix
from ceph_tpu_torch.gf.reference_codec import apply_matrix as apply_ref
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain, gf_apply, kernel_for
from chip_smoke import K3_EDGE_CASES, k3_edge_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("rows,n,L", [
    (4, 8, 3000), (1, 2, 9001), (8, 8, 4096), (13, 5, 4101), (16, 32, 777),
    (64, 176, 1030), (13, 40, 300), (17, 3, 5000), (2, 400, 129),
    (16, 228, 3001), (5, 2000, 1031), (256, 960, 1030),
    # K2's edges: rows 1, 7, 9 (n large enough for K2), 63, 65 with n 1, 3, 5
    (1, 600, 129), (7, 80, 127), (9, 60, 257), (63, 1, 255), (63, 5, 129),
    (65, 3, 127), (65, 5, 1031), (65, 1, 128), (17, 65, 256), (24, 64, 384),
    (20, 70, 511), (33, 9, 513),
])
def test_kernel_matches_plain(cuda, rows, n, L):
    rng = np.random.default_rng(rows * 1000 + n)
    mat = _rand(rng, (rows, n))
    x = torch.from_numpy(_rand(rng, (n, L))).to(cuda)
    before = dict(gf_kernels.LAUNCHES)
    out = gf_apply(mat, [x])
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES[kernel_for(rows, n)] == before[kernel_for(rows, n)] + 1
    assert torch.equal(out, apply_matrix_plain(mat, x))
    np.testing.assert_array_equal(out.cpu().numpy(), apply_ref(mat, x.cpu().numpy()))


@pytest.mark.parametrize("rows,n,nseg", [
    (4, 8, 5), (64, 176, 5), (256, 960, 5), (64, 176, 333),
])
def test_segments_strided_and_unaligned(cuda, rows, n, nseg):
    """One launch over views at odd offsets and row strides, with ragged
    and empty segments, equals the plain apply of their concatenation."""
    rng = np.random.default_rng(rows + n + nseg)
    mat = _rand(rng, (rows, n))
    base = torch.from_numpy(_rand(rng, (n, 20011))).to(cuda)
    segs = [base[:, 1:4097], base[:, 4100:4100], base[:, 5003:9010],
            base[:, 9999:20011], base[:, 3:6]]
    for start, length in zip(rng.integers(0, 19800, nseg - len(segs)),
                             rng.integers(0, 200, nseg - len(segs))):
        segs.append(base[:, start:start + length])
    name = kernel_for(rows, n)
    before = gf_kernels.LAUNCHES[name]
    out = gf_apply(mat, segs)
    want = apply_matrix_plain(mat, torch.cat(segs, dim=1).contiguous())
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES[name] == before + 1
    assert torch.equal(out, want)


def test_fused_encode_one_launch(cuda):
    from ceph_tpu_torch.ops.bitplane import fused_encode

    rng = np.random.default_rng(5)
    coding = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
    stripes = [torch.from_numpy(_rand(rng, (8, L))).to(cuda) for L in (4096, 64, 12345)]
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    par = fused_encode(coding, stripes)
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 1
    want = np.concatenate([apply_ref(coding, s.cpu().numpy()) for s in stripes], axis=1)
    np.testing.assert_array_equal(par.cpu().numpy(), want)


def test_clay_wide_repair(cuda):
    """CLAY(12,4,d=15) repair: a [256, 960] matrix, all 960 inputs in
    one K2 launch."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    clay = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "clay", "k": "12", "m": "4", "d": "15"}, device=cuda)
    L = 65 * clay.get_sub_chunk_count()  # sub-chunks of 65 bytes: unaligned words
    data = torch.from_numpy(_rand(np.random.default_rng(15), (12, L))).to(cuda)
    parity = clay.encode_chunks(data)
    have = {i: data[i] for i in range(1, 12)}
    have.update({12 + i: parity[i] for i in range(4)})
    before = gf_kernels.LAUNCHES["gf_apply_k2"]
    got = clay.decode({0}, have, L)
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k2"] == before + 1
    assert torch.equal(got[0], data[0])


def test_bad_inputs_raise(cuda):
    mat = np.ones((2, 3), np.uint8)
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((4, 10), dtype=torch.uint8, device=cuda)])
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((3, 10), dtype=torch.int32, device=cuda)])
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((10, 3), dtype=torch.uint8, device=cuda).t()])


def test_prepared_launch_repeats(cuda):
    """A staged launch (what chip_smoke.py times) relaunches into the same
    output, counts every launch and gives the wrapper's bytes."""
    rng = np.random.default_rng(9)
    mat = _rand(rng, (4, 8))
    segs = [torch.from_numpy(_rand(rng, (8, 5000))).to(cuda) for _ in range(3)]
    launch = gf_kernels.prepare(mat, segs)
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    first = launch().clone()
    second = launch()
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 2
    assert torch.equal(first, second) and torch.equal(second, gf_apply(mat, segs))


# ---- K1: its tiles, its rows and depth, its descriptor routes ----


def _k1_matches_plain(mat, segs):
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    out = gf_apply(mat, segs)
    want = apply_matrix_plain(mat, torch.cat(segs, dim=1).contiguous())
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize("tile", [16 * t * v for t, v in gf_kernels.K1_TILES])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_k1_each_tile_at_its_boundary(cuda, tile, delta):
    """K1 at each tile k1_layout chooses, at a length one below, at and
    one past a multiple of the tile (two tiles an SM), RS(8,4)'s encode
    and decode shapes."""
    sms = sm_count(cuda)
    L = 2 * sms * tile + delta
    rng = np.random.default_rng(tile + delta)
    x = torch.from_numpy(_rand(rng, (8, L))).to(cuda)
    for rows in (4, 8):
        assert gf_kernels.k1_layout(L, 1, sms).tile_cols == tile
        _k1_matches_plain(_rand(rng, (rows, 8)), [x])


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 7, 8, 9, 12, 16])
def test_k1_rows_and_depth(cuda, rows):
    """Rows 1 to 16 (each MAXR instantiation, full and partial), n from 1
    through a trip of K1_RING rows and one past it up to the K1/K2 rule's
    edge, rows * n = 512; a ragged length."""
    rng = np.random.default_rng(rows)
    edge = 512 // rows
    assert kernel_for(rows, edge) == "gf_apply_k1"
    assert kernel_for(rows, edge + 1) == "gf_apply_k2"
    for n in sorted({1, 2, 7, 8, 9, 16, 17, edge}):
        if n <= edge:
            x = torch.from_numpy(_rand(rng, (n, 4099))).to(cuda)
            _k1_matches_plain(_rand(rng, (rows, n)), [x])


@pytest.mark.parametrize("nseg", [1, gf_kernels.K1_PARAM_SEGS, gf_kernels.K1_PARAM_SEGS + 1, 256])
@pytest.mark.parametrize("shape", [(4, 8), (8, 8), (13, 5)])
def test_k1_descriptor_routes(cuda, nseg, shape):
    """Segment descriptors by value in K1's parameters (up to
    K1_PARAM_SEGS) and from a device array (past it): unaligned offsets,
    a row-strided view, ragged and empty segments in one launch."""
    rows, n = shape
    rng = np.random.default_rng(nseg * 100 + rows)
    mat = _rand(rng, (rows, n))
    base = torch.from_numpy(_rand(rng, (2 * n, 20011))).to(cuda)
    flat, strided = base[:n], base[::2]  # strided: a row stride of 2 x 20011
    pool = [flat[:, 0:16384], strided[:, 16:8208], flat[:, 1:4097], flat[:, 4100:4100],
            strided[:, 3:3000], flat[:, 9999:20011]]
    segs = pool[:nseg]
    for start, length in zip(rng.integers(0, 19800, nseg - len(segs)),
                             rng.integers(0, 200, nseg - len(segs))):
        segs.append((flat if start % 2 else strided)[:, start:start + length])
    _k1_matches_plain(mat, segs)


# ---- K3 and the crush_ln probe (ceph_tpu_torch/ops/crush_kernels.py) ----


def _straw2_case(S, n_idx, P, B, seed):
    """A random straw2 table: ragged sizes up to S (one empty bucket), a
    zero-weight slot, weights up to a root's, P weight rows per bucket."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, n_idx).astype(np.int32)
    sizes[n_idx // 2] = 0
    items = np.full((n_idx, S), -0x7FFFFFFE, dtype=np.int32)
    weights = np.zeros((P * n_idx, S), dtype=np.int64)
    for b in range(n_idx):
        items[b, :sizes[b]] = rng.integers(-1000, 1000, sizes[b])
        for p in range(P):
            weights[p * n_idx + b, :sizes[b]] = rng.integers(0, 1 << 27, sizes[b])
    weights[0, 0] = 0
    lanes = [rng.integers(-1, n_idx + 1, B), rng.integers(-(1 << 31), 1 << 31, B),
             rng.integers(0, 200, B), rng.integers(-1, P + 2, B)]
    return [items, weights, sizes] + [a.astype(np.int32) for a in lanes]


_EDGE = {c[0]: c[1:] for c in K3_EDGE_CASES}


@pytest.mark.parametrize("kind,S,n_idx,P,B,T", [
    ("random", 1, 3, 1, 1000, None), ("random", 8, 17, 1, 4097, None),
    ("random", 128, 129, 1, 65537, None), ("random", 8, 9, 3, 3001, None),
    ("random", 128, 5, 2, 777, None), ("random", 37, 11, 1, 1, None),
] + [("edge", *_EDGE[name], T) for name in _EDGE for T in (None, 1, 2, 8, 32)])
def test_straw2_choose_matches_plain(cuda, kind, S, n_idx, P, B, T):
    """K3 at T threads a lane (None: the host's choice) against the plain
    version on the card and on the CPU: random tables, and chip_smoke.py's
    edge tables (B across the thread choices, S of 1, 8, 37 and 128, ties,
    weights 1, 2^16, 2^31, 0xFFFFFFFF and 0, an all-zero bucket, P = 3)."""
    from ceph_tpu_torch.ops import crush_kernels

    make = _straw2_case if kind == "random" else k3_edge_case
    args = [torch.from_numpy(a).to(cuda) for a in make(S, n_idx, P, B, S * B)]
    before = crush_kernels.LAUNCHES["crush_straw2_k3"]
    got = crush_kernels.straw2_choose(*args, threads=T)
    want = crush_kernels.straw2_choose_plain(*args)
    torch.cuda.synchronize()
    assert crush_kernels.LAUNCHES["crush_straw2_k3"] == before + 1
    assert torch.equal(got, want)
    cpu = crush_kernels.straw2_choose_plain(*[a.cpu() for a in args])
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("B,S", [(1, 1), (300, 8), (4097, 128), (64, 37)])
def test_ln_scores_matches_plain(cuda, B, S):
    from ceph_tpu_torch.ops import crush_kernels

    rng = np.random.default_rng(B + S)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, B).astype(np.int32)).to(cuda)
    r = torch.from_numpy(rng.integers(0, 100, B).astype(np.int32)).to(cuda)
    items = torch.from_numpy(rng.integers(-500, 500, (B, S)).astype(np.int32)).to(cuda)
    got = crush_kernels.ln_scores(x, items, r)
    assert torch.equal(got, crush_kernels.ln_scores_plain(x, items, r))


@pytest.mark.parametrize("form", ["compute", "table"])
def test_ln_stream_every_u(cuda, form):
    from ceph_tpu_torch.crush.ln_table import CRUSH_LN_TABLE
    from ceph_tpu_torch.ops import crush_kernels

    u = torch.arange(1 << 16, dtype=torch.int32, device=cuda).flip(0)
    got = crush_kernels.crush_ln_stream(u, form)
    np.testing.assert_array_equal(got.cpu().numpy(), CRUSH_LN_TABLE[::-1])


def test_batch_mapper_on_the_card(cuda):
    """The port's batch mapper on the card (every draw a K3 launch) equals
    the same mapper on the CPU and the scalar mapper."""
    from ceph_tpu_torch.crush import CrushWrapper, ITEM_NONE, build_hierarchical_map
    from ceph_tpu_torch.ops import crush_kernels

    w = CrushWrapper(build_hierarchical_map(32, 4, racks=4))
    weights = np.full(128, 0x10000)
    weights[[3, 40]] = 0
    weights[9] = 0x8000
    xs = np.arange(3000)
    for rule, nrep in ((0, 3), (1, 6)):
        before = crush_kernels.LAUNCHES["crush_straw2_k3"]
        got = w.do_rule_batch(rule, xs, nrep, weights).cpu()
        assert crush_kernels.LAUNCHES["crush_straw2_k3"] > before
        assert torch.equal(got, w.do_rule_batch(rule, xs, nrep, weights, device="cpu"))
        for x in range(0, 3000, 61):
            exp = w.do_rule(rule, x, nrep, list(weights))
            assert got[x].tolist() == (exp + [ITEM_NONE] * nrep)[:nrep]



# ---- the OSDMap's pool-wide mapping ----


def _osdmap_pair(pg_num, size, erasure, device):
    """An OSDMap on 8 hosts x 4 OSDs with one pool, an OSD out, one down,
    an upmap, upmap items, a pg_temp and primary affinity below 1."""
    from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map
    from ceph_tpu_torch.osd import PG_POOL_ERASURE, OSDMap

    m = OSDMap(CrushWrapper(build_hierarchical_map(8, 4)), device=device)
    m.create_pool(1, pg_num=pg_num, size=size, crush_rule=1 if erasure else 0,
                  **({"type": PG_POOL_ERASURE} if erasure else {}))
    m.mark_out(5)
    m.mark_down(9)
    for o in (0, 13, 22):
        m.set_primary_affinity(o, 0.25)
    m.pg_upmap[(1, 0)] = list(range(size)) if size <= 32 else []
    m.pg_upmap_items[(1, pg_num - 1)] = [(0, 31), (4, 30)]
    m.pg_temp[(1, 1 % pg_num)] = [7, 8]
    return m


@pytest.mark.parametrize("pg_num,size,erasure", [
    (1000, 3, False), (777, 10, True), (1, 3, False), (4097, 6, True), (33, 12, True),
])
def test_map_pool_on_the_card(cuda, pg_num, size, erasure):
    """OSDMap.map_pool on the card equals device="cpu" and the scalar
    pg_to_up_acting_osds: pg_num not a power of two, and EC pools wider
    than the 8 hosts, whose indep rule leaves ITEM_NONE holes."""
    from ceph_tpu_torch.crush import ITEM_NONE
    from ceph_tpu_torch.ops import crush_kernels

    m = _osdmap_pair(pg_num, size, erasure, None)
    cpu = _osdmap_pair(pg_num, size, erasure, "cpu")
    before = crush_kernels.LAUNCHES["crush_straw2_k3"]
    up, prim = m.map_pool(1)
    assert m.device.type == "cuda"
    assert crush_kernels.LAUNCHES["crush_straw2_k3"] > before
    cup, cprim = cpu.map_pool(1)
    np.testing.assert_array_equal(up, cup)
    np.testing.assert_array_equal(prim, cprim)
    if size > 8:
        assert (up == ITEM_NONE).any()
    for ps in range(0, pg_num, max(1, pg_num // 61)):
        u, p, _, _ = m.pg_to_up_acting_osds(1, ps)
        assert up[ps].tolist() == (u if erasure else (u + [ITEM_NONE] * size)[:size])
        assert prim[ps] == p


def test_osdmap_without_a_device_maps_on_the_card_or_raise():
    """No ``device``: OSDMap.map_pool runs on the card, or raises without
    one (never on the CPU).  Runs on both kinds of machine."""
    m = _osdmap_pair(64, 3, False, None)
    if torch.cuda.is_available():
        m.map_pool(1)
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m.map_pool(1)


# ---- the OSD's batchers, the device pool and the stream pipeline ----


def test_batchers_without_a_device_run_on_the_card_or_raise():
    """No ``device``: the batchers run on the card, or raise without one
    (never on the CPU).  Runs on both kinds of machine."""
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.osd.read_batcher import ReadBatcher
    from ceph_tpu_torch.osd.write_batcher import WriteBatcher

    cct = CephContext("osd.1")
    for make in (lambda: WriteBatcher(cct), lambda: ReadBatcher(cct, io=None)):
        if torch.cuda.is_available():
            assert make()._device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_pool_buffer_released_under_k1_keeps_its_bytes(cuda):
    """A pooled buffer released while K1 still reads it (K1 queued on a
    stream held back by a spin kernel) and refilled at once from another
    stream: the refill waits for K1, whose output is still the apply of
    the old bytes."""
    from ceph_tpu_torch.ops.device_pool import DevicePool

    rng = np.random.default_rng(21)
    mat = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
    old, new = _rand(rng, (8, 1 << 22)), _rand(rng, (8, 1 << 22))
    want = apply_matrix_plain(mat, torch.from_numpy(old).to(cuda))
    pool = DevicePool(max_bytes=1 << 30)
    x = pool.put(old, cuda)
    torch.cuda.synchronize()
    held, other = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(held):
        torch.cuda._sleep(200_000_000)  # ~0.1 s: K1 below waits behind it
        out = gf_apply(mat, [x])
        pool.release(x)  # its last use is K1 on `held`
    with torch.cuda.stream(other):
        y = pool.put(new, cuda)  # the same buffer, refilled on `other`
    assert y.data_ptr() == x.data_ptr() and pool.stats()["donations"] == 1
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    np.testing.assert_array_equal(y.cpu().numpy(), new)


@pytest.mark.parametrize("lengths", [(1, 4097, 131072, 3, 65541), (4096,) * 5, (7,)])
def test_stream_encode_pinned_ragged(cuda, lengths, monkeypatch):
    """stream_encode on the card from pinned staging: one K1 launch per
    batch, each parity equal to the numpy referee, at ragged batch sizes
    and with a batch given as a list of stripes."""
    from ceph_tpu_torch.ops.pipeline import stream_encode

    staged = []
    empty = torch.empty

    def spy(*shape, pin_memory=False, **kw):
        staged.append(pin_memory)
        return empty(*shape, pin_memory=pin_memory, **kw)

    monkeypatch.setattr(torch, "empty", spy)

    rng = np.random.default_rng(sum(lengths))
    mat = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
    batches = [_rand(rng, (8, L)) for L in lengths]
    parts = [_rand(rng, (8, 100)), _rand(rng, (8, 33))]
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    outs = stream_encode(mat, iter(batches + [parts]))
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + len(batches) + 1
    for x, got in zip(batches + [np.concatenate(parts, axis=1)], outs):
        np.testing.assert_array_equal(got, apply_ref(mat, x))
    assert staged.count(True) == len(batches) + 1  # one pinned staging per batch


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "pool_off"])
def test_batchers_on_the_card(cuda, pool):
    """The write batcher's fused flush and the read batcher's grouped
    decode on the card: one K1 launch per flush group, bytes equal to the
    numpy referee, nothing inline."""
    import threading

    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.gf.matrix import decode_matrix_for, systematic_generator
    from ceph_tpu_torch.osd.read_batcher import ReadBatcher
    from ceph_tpu_torch.osd.write_batcher import WriteBatcher

    rng = np.random.default_rng(22)
    mat = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
    xs = [_rand(rng, (8, 4096 + 512 * (i % 3))) for i in range(24)]
    cct = CephContext("osd.1", overrides={
        "ec_batch_window_ms": 10_000.0, "ec_batch_max_stripes": 24,
        "osd_read_batch_window_ms": 10_000.0, "osd_read_batch_max_ops": 24,
        "ec_device_pool": pool})
    wb = WriteBatcher(cct)
    wb.start()
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    try:
        outs = [None] * len(xs)
        ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, wb.encode_chunks(mat, xs[i]))) for i in range(len(xs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        wb.stop()
    st = wb.stats()
    assert (st["flushes"], st["inline"], st["device_batches"]) == (1, 0, 3)
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 3
    for x, got in zip(xs, outs):
        np.testing.assert_array_equal(got, apply_ref(mat, x))

    avail = [0, 2, 3, 5, 6, 7, 8, 10]  # shards 1, 4, 9, 11 lost
    dm = decode_matrix_for(systematic_generator(mat), 8, avail).astype(np.uint8)
    stacks = [np.vstack([x, apply_ref(mat, x)])[avail] for x in xs]
    rb = ReadBatcher(cct, io=None)
    rb.start()
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    try:
        got = [None] * len(xs)
        ts = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, rb.decode(dm, stacks[i]))) for i in range(len(xs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        rb.stop()
    st = rb.stats()
    assert (st["flushes"], st["inline"], st["decode_groups"]) == (1, 0, 1)
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 1
    for x, out in zip(xs, got):
        np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("rows,n,L,iters", [
    (4, 8, 3001, 7), (1, 2, 65537, 5), (1, 4, 4099, 3),   # K1: RS(8,4), RS(2,1), SHEC
    (64, 176, 1030, 4), (17, 65, 256, 3),                  # K2: CLAY's repair, ragged
])
def test_chained_encode_matches_the_plain_chain(cuda, rows, n, L, iters):
    """bench/timing.py's chain on the card (one staged K1 or K2 launch an
    iteration, kernel_for choosing) against the same chain of the plain
    version, and time_chained_encode labels its clock cuda."""
    from ceph_tpu_torch.bench.timing import make_chained_encode, time_chained_encode

    rng = np.random.default_rng(rows * 100 + n)
    mat = _rand(rng, (rows, n))
    x = _rand(rng, (n, L))
    k1 = gf_kernels.LAUNCHES[kernel_for(rows, n)]
    loop, prep = make_chained_encode(mat, device=cuda)
    got = loop(prep(x), iters)
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES[kernel_for(rows, n)] == k1 + iters
    want = torch.from_numpy(x).to(cuda)
    for _ in range(iters):
        want[:rows] ^= apply_matrix_plain(mat, want)
    assert torch.equal(got, want)
    t = time_chained_encode(mat, x, iters, device=cuda, subtract_overhead=True, repeats=2)
    assert t.device == "cuda" and t.seconds > 0
