"""The port's device pool and stream pipeline against the reference's, on
the CPU (ops/device_pool.py, ops/pipeline.py, ops/bitplane.py's
fused_encode_async): the contracts of tests/test_device_pool.py that are
not about JAX — geometry keys and LRU bounds, disable drains, the
degraded sentinel's bypass, fused equals host pack, async demux equal to
inline, the flush's telemetry split, stream_encode parity and recycling,
decodes through the pool.  Each case runs the same scenario through both
packages; tolerance: byte equality and equal counts.  Donations are the
one stat that differs: the reference's CPU backend ignores donation,
the port refills a recycled buffer in place on every device.
"""
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from ceph_tpu.common.context import CephContext as RefContext
from ceph_tpu.common.kernel_telemetry import SENTINEL as REF_SENTINEL
from ceph_tpu.common.kernel_telemetry import TELEMETRY as REF_TELEMETRY
from ceph_tpu.gf.matrix import cauchy_good_coding_matrix
from ceph_tpu.gf.reference_codec import apply_matrix as ref_apply
from ceph_tpu.ops import bitplane as ref_bp
from ceph_tpu.ops import device_pool as ref_dp
from ceph_tpu.ops.pipeline import stream_encode as ref_stream_encode
from ceph_tpu.osd.read_batcher import ReadBatcher as RefReadBatcher
from ceph_tpu.osd.write_batcher import WriteBatcher as RefWriteBatcher
from ceph_tpu_torch.common.context import CephContext
from ceph_tpu_torch.common.kernel_telemetry import SENTINEL, TELEMETRY
from ceph_tpu_torch.ops import bitplane as bp
from ceph_tpu_torch.ops import device_pool as dp
from ceph_tpu_torch.ops.pipeline import stream_encode
from ceph_tpu_torch.osd.read_batcher import ReadBatcher
from ceph_tpu_torch.osd.write_batcher import WriteBatcher

MAT84 = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
MAT42 = cauchy_good_coding_matrix(4, 2).astype(np.uint8)

REF = SimpleNamespace(
    dp=ref_dp, sentinel=REF_SENTINEL, telemetry=REF_TELEMETRY, Context=RefContext,
    WriteBatcher=RefWriteBatcher, ReadBatcher=RefReadBatcher, digest=ref_bp.matrix_digest,
    kw={}, acquire=lambda pool, shape: pool.acquire(shape, np.uint8),
    put=lambda pool, x: pool.put(x),
    stream=lambda mat, it, key: ref_stream_encode(mat, it, kernel="auto", mat_key=key))
PORT = SimpleNamespace(
    dp=dp, sentinel=SENTINEL, telemetry=TELEMETRY, Context=CephContext,
    WriteBatcher=WriteBatcher, ReadBatcher=ReadBatcher, digest=bp.matrix_digest,
    kw={"device": "cpu"}, acquire=lambda pool, shape: pool.acquire(shape, device="cpu"),
    put=lambda pool, x: pool.put(x, "cpu"),
    stream=lambda mat, it, key: stream_encode(mat, it, "cpu", mat_key=key))
#: stats both pools keep alike
COMMON = ("hits", "misses", "evictions", "puts", "releases", "resident_bytes",
          "geometries", "max_bytes", "enabled")


@pytest.fixture(autouse=True)
def _clean_pools():
    for side in (REF, PORT):
        side.dp.POOL.configure(enabled=True, max_bytes=256 << 20)
        side.dp.POOL.clear()
    yield
    for side in (REF, PORT):
        side.sentinel.reset_state()
        side.dp.POOL.configure(enabled=True, max_bytes=256 << 20)
        side.dp.POOL.clear()


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _common(stats):
    return {k: stats[k] for k in COMMON}


# -- the pool itself: each scenario returns what is compared -----------------

def pool_geometry_lru(side):
    pool = side.dp.DevicePool(max_bytes=3 * 2048, enabled=True)
    a = [side.put(pool, _rand(i, (8, 256))) for i in range(2)]  # geometry A
    b = side.put(pool, _rand(2, (4, 512)))                       # geometry B
    for buf in a + [b]:
        pool.release(buf)
    seen = [_common(pool.stats())]
    hit = side.acquire(pool, (8, 256))       # same geometry: a hit
    miss = side.acquire(pool, (2, 64))       # foreign geometry: a miss
    seen.append((hit is not None, miss is None, _common(pool.stats())))
    # overflow evicts the least-recently-USED geometry wholesale: A was
    # touched by the hit, so B goes first
    pool.release(side.put(pool, _rand(3, (8, 256))))
    pool.release(side.put(pool, _rand(4, (16, 256))))
    seen.append((side.acquire(pool, (4, 512)) is None, _common(pool.stats())))
    assert seen[-1][0] and pool.stats()["resident_bytes"] <= pool.max_bytes
    return seen


def pool_disable_drains(side):
    pool = side.dp.DevicePool(max_bytes=1 << 20, enabled=True)
    pool.release(side.put(pool, _rand(5, (8, 64))))
    seen = [pool.stats()["resident_bytes"]]
    pool.configure(enabled=False)
    seen += [pool.stats()["resident_bytes"], pool.enabled()]
    buf = side.put(pool, _rand(6, (8, 64)))  # a plain transfer
    pool.release(buf)                        # a no-op
    seen += [pool.stats()["resident_bytes"], np.asarray(buf).tobytes()]
    assert seen[1:4] == [0, False, 0]
    return seen


def pool_sentinel_bypass(side):
    seen = [side.dp.POOL.enabled()]
    side.sentinel.force("degraded", "test wedge")
    try:
        seen.append(side.dp.POOL.enabled())
    finally:
        side.sentinel.reset_state()
    seen.append(side.dp.POOL.enabled())
    assert seen == [True, False, True]
    return seen


POOL_CASES = {"geometry_lru": pool_geometry_lru, "disable_drains": pool_disable_drains,
              "sentinel_bypass": pool_sentinel_bypass}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    assert POOL_CASES[case](PORT) == POOL_CASES[case](REF)


# -- the data paths through the pool -----------------------------------------

def _wb(side, **overrides):
    conf = {"ec_batch_window_ms": 50.0, "ec_batch_max_stripes": 64,
            "ec_batch_max_bytes": 8 << 20}
    conf.update(overrides)
    b = side.WriteBatcher(side.Context("osd.dp", overrides=conf), entity="osd.dp",
                          **side.kw)
    b.start()
    return b


def _encode_all(b, items):
    try:
        tickets = [b.encode_submit(m, s, mat_key=k) for m, s, k in items]
        return [np.asarray(b.encode_wait(t)) for t in tickets]
    finally:
        b.stop()


def path_async_demux(side):
    """Pooled async flushes and the pool-off control give the same
    parity, to the byte, as the numpy referee."""
    key = side.digest(MAT84)
    stripes = [_rand(10 + i, (8, 256)) for i in range(6)]
    outs = []
    for pool_on in (True, False):
        got = _encode_all(_wb(side, ec_device_pool=pool_on, ec_batch_max_stripes=6),
                          [(MAT84, s, key) for s in stripes])
        for o, s in zip(got, stripes):
            np.testing.assert_array_equal(o, ref_apply(MAT84, s))
        outs.append(got)
    return outs


def path_mixed_geometry(side):
    """Two geometries in one pooled flush; both parity parents recycle."""
    big = [_rand(20 + i, (8, 256)) for i in range(4)]
    small = [_rand(30 + i, (4, 128)) for i in range(3)]
    items = [(MAT84, s, side.digest(MAT84)) for s in big] + \
        [(MAT42, s, side.digest(MAT42)) for s in small]
    outs = _encode_all(_wb(side, ec_batch_max_stripes=16), items)
    for o, (m, s, _k) in zip(outs, items):
        np.testing.assert_array_equal(o, ref_apply(m, s))
    assert side.dp.POOL.stats()["releases"] >= 2
    return outs


def path_group_keying(side):
    """Two different matrices of one shape never fuse into one group."""
    mat_b = MAT84.copy()
    mat_b[0, 0] ^= 0x55
    s = [_rand(40 + i, (8, 128)) for i in range(2)]
    outs = _encode_all(_wb(side, ec_batch_max_stripes=8),
                       [(MAT84, s[0], side.digest(MAT84)), (mat_b, s[1], side.digest(mat_b))])
    np.testing.assert_array_equal(outs[1], ref_apply(mat_b, s[1]))
    return outs


def path_telemetry_split(side):
    """Pooled flush: its host copy is the stripes' commit and it is no
    sync point; the commit sync rides the encode_wait record.  Control
    flush: a sync point that copies more than the stripes."""
    side.telemetry.enable(True)
    stripes = [_rand(50 + i, (8, 256)) for i in range(4)]
    items = [(MAT84, s, side.digest(MAT84)) for s in stripes]

    def deltas(pool_on):
        d0 = side.telemetry.dump()
        _encode_all(_wb(side, ec_device_pool=pool_on, ec_batch_max_stripes=4), items)
        d1 = side.telemetry.dump()
        return {f"{k}.{f}": d1.get(k, {}).get(f, 0) - d0.get(k, {}).get(f, 0)
                for k in ("ec_batch_flush", "encode_wait")
                for f in ("host_copy_bytes", "sync_points")}

    pooled, control = deltas(True), deltas(False)
    nbytes = sum(s.nbytes for s in stripes)
    assert pooled["ec_batch_flush.host_copy_bytes"] == nbytes
    assert pooled["ec_batch_flush.sync_points"] == 0
    assert pooled["encode_wait.sync_points"] > 0
    assert control["ec_batch_flush.sync_points"] > 0
    assert control["ec_batch_flush.host_copy_bytes"] > nbytes
    names = set(side.telemetry.perf.schema())
    assert {"device_pool_hits", "device_pool_misses", "device_pool_evictions",
            "device_pool_resident_bytes"} <= names
    return [pooled, control]


def path_stream_encode(side):
    """stream_encode with the pool on and off: parity per batch equal to
    the referee, and with the pool on, hits after the first batch."""
    batches = [_rand(60 + i, (8, 512)) for i in range(4)]
    key = side.digest(MAT84)
    h0 = side.dp.POOL.stats()["hits"]
    outs_on = side.stream(MAT84, iter(batches), key)
    hits = side.dp.POOL.stats()["hits"] - h0
    side.dp.POOL.configure(enabled=False)
    outs_off = side.stream(MAT84, iter(batches), key)
    side.dp.POOL.configure(enabled=True)
    for a, b, x in zip(outs_on, outs_off, batches):
        np.testing.assert_array_equal(np.asarray(a), ref_apply(MAT84, x))
        np.testing.assert_array_equal(np.asarray(b), ref_apply(MAT84, x))
    if side is PORT:  # the reference's CPU pool never gets a release back
        assert hits >= len(batches) - 1
    return [np.asarray(o) for o in outs_on + outs_off]


def path_decodes_through_pool(side):
    """Repeated same-geometry decodes through the read batcher recycle
    their committed stacks through the pool."""
    gen = np.vstack([np.eye(4, dtype=np.uint8), MAT42])
    x = _rand(70, (4, 4096))
    full = np.vstack([x, ref_apply(MAT42, x)])
    from ceph_tpu_torch.gf.matrix import decode_matrix_for

    rows = [1, 2, 3, 4]
    dm = decode_matrix_for(gen, 4, rows).astype(np.uint8)
    cct = side.Context("osd.dp", overrides={"osd_read_batch_window_ms": 0.0})
    rb = side.ReadBatcher(cct, io=None, entity="osd.dp", **side.kw)
    h0 = side.dp.POOL.stats()["hits"]
    outs = [rb.decode(dm, full[rows]) for _ in range(3)]  # inline: solo dispatches
    for o in outs:
        np.testing.assert_array_equal(o, x)
    assert side.dp.POOL.stats()["hits"] - h0 >= (2 if side is PORT else 0)
    return outs


PATH_CASES = {"async_demux": path_async_demux, "mixed_geometry": path_mixed_geometry,
              "group_keying": path_group_keying, "telemetry_split": path_telemetry_split,
              "stream_encode": path_stream_encode,
              "decodes_through_pool": path_decodes_through_pool}


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_pool_path_matches_reference(case):
    _same(PATH_CASES[case](PORT), PATH_CASES[case](REF))


def test_fused_encode_async_equals_host_pack():
    """fused_encode_async leaves the parity on the device, equal to the
    reference's fused encode of the same stripes (whose arity the
    reference pads to a power of two with zero stripes; the port's one
    launch takes any count) and to the apply of the host pack."""
    stripes = [_rand(80 + i, (8, 256)) for i in range(5)]
    packed = np.concatenate(stripes, axis=1)
    got = bp.fused_encode_async(MAT84, stripes, "cpu", bp.matrix_digest(MAT84))
    assert isinstance(got, torch.Tensor) and got.shape == (4, packed.shape[1])
    ref = np.asarray(ref_bp.fused_encode_async(MAT84, stripes))
    np.testing.assert_array_equal(got.numpy(), ref[:, :packed.shape[1]])
    np.testing.assert_array_equal(got.numpy(), ref_apply(MAT84, packed))
    assert bp.current_backend("cpu") == "cpu"


def test_commit_packs_through_the_pool():
    """commit packs host arrays column-wise into one pooled buffer; a
    released buffer of the same geometry is refilled in place."""
    parts = [_rand(90, (8, 100)), _rand(91, (8, 28))]
    s0 = dp.POOL.stats()
    first = dp.commit(parts, "cpu")
    np.testing.assert_array_equal(first.numpy(), np.concatenate(parts, axis=1))
    dp.POOL.release(first)
    again = dp.commit(parts[::-1], "cpu")
    assert again.data_ptr() == first.data_ptr()
    np.testing.assert_array_equal(again.numpy(), np.concatenate(parts[::-1], axis=1))
    st = dp.POOL.stats()
    assert [st[k] - s0[k] for k in ("hits", "donations", "puts")] == [1, 1, 2]
    fresh = dp.commit(parts, "cpu", pooled=False)
    assert dp.POOL.stats()["puts"] == st["puts"] and fresh.data_ptr() != again.data_ptr()
