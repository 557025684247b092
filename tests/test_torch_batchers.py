"""The port's WriteBatcher and ReadBatcher against the reference's, on the
CPU: both built from the same overrides dict, the port's codec carrying
the reference codec's coding matrix (``ec/state.py::codec_from_arrays``),
fed the same numpy-seeded stripes and in-memory I/O stores.  Tolerance:
byte equality of every parity, decoded window and gathered row, and
equal batcher stats (the port adds ``device_batches``, the applies its
flushes issued).  Each case runs the same scenario through both packages:
flush triggers, mixed geometry, the oversize split, an error failing the
whole batch, the crash latch, shutdown, grouped decode demux and ranged
degraded decode.  Also: every option the slice reads has the same name,
type and default in both option tables.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.common import failpoint as ref_failpoint
from ceph_tpu.common.context import CephContext as RefContext
from ceph_tpu.common.options import default_options as ref_options
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.gf.matrix import cauchy_good_coding_matrix
from ceph_tpu.gf.reference_codec import encode_chunks as ref_encode
from ceph_tpu.ops.device_pool import POOL as REF_POOL
from ceph_tpu.osd.messages import pack_data as ref_pack
from ceph_tpu.osd.read_batcher import ReadBatcher as RefReadBatcher
from ceph_tpu.osd.read_batcher import ReadReq as RefReadReq
from ceph_tpu.osd.write_batcher import WriteBatcher as RefWriteBatcher
from ceph_tpu_torch.common import failpoint as port_failpoint
from ceph_tpu_torch.common.context import CephContext
from ceph_tpu_torch.common.options import default_options
from ceph_tpu_torch.ec.state import codec_from_arrays
from ceph_tpu_torch.ops.device_pool import POOL
from ceph_tpu_torch.osd.messages import pack_data
from ceph_tpu_torch.osd.read_batcher import ReadBatcher, ReadReq
from ceph_tpu_torch.osd.write_batcher import WriteBatcher

PROFILE = {"technique": "cauchy_good", "k": "8", "m": "4"}
REF_CODEC = RefRegistry.instance().factory({**PROFILE, "plugin": "jax"})
PORT_CODEC = codec_from_arrays({**PROFILE, "plugin": "torch"},
                               {"coding": REF_CODEC.coding}, device="cpu")
MAT21 = cauchy_good_coding_matrix(2, 1).astype(np.uint8)

#: the two packages under one interface: each case runs once per side
REF = SimpleNamespace(
    name="ref", Context=RefContext, WriteBatcher=RefWriteBatcher,
    ReadBatcher=RefReadBatcher, ReadReq=RefReadReq, fp=ref_failpoint,
    pack=ref_pack, kw={},
    mat84=REF_CODEC.coding, key84=REF_CODEC._jax_codec.coding_digest,
    decode_entry=REF_CODEC._jax_codec._decode_entry)
PORT = SimpleNamespace(
    name="port", Context=CephContext, WriteBatcher=WriteBatcher,
    ReadBatcher=ReadBatcher, ReadReq=ReadReq, fp=port_failpoint,
    pack=pack_data, kw={"device": "cpu"},
    mat84=PORT_CODEC.coding, key84=PORT_CODEC.bitplane.coding_digest,
    decode_entry=PORT_CODEC.bitplane._decode_entry)


@pytest.fixture(autouse=True)
def _clean_state():
    """Each package has its own failpoint registry and device pool."""
    for side in (REF, PORT):
        side.fp.registry().clear()
    for pool in (REF_POOL, POOL):
        pool.configure(enabled=True, max_bytes=256 << 20)
        pool.clear()
    yield
    for side in (REF, PORT):
        side.fp.registry().clear()


def _stripes(n, k=8, L=512, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (k, L), dtype=np.uint8) for _ in range(n)]


def _threads(fn, items):
    """One thread per item; (outs, errs) in item order once all joined."""
    outs = [None] * len(items)
    errs = [None] * len(items)

    def go(i):
        try:
            outs[i] = fn(items[i])
        except Exception as e:  # collected for the comparison
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(items))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in ts)
    return outs, errs


def _wb(side, **overrides):
    conf = {"ec_batch_window_ms": 10_000.0, "ec_batch_max_stripes": 10_000,
            "ec_batch_max_bytes": 1 << 30}
    conf.update(overrides)
    wb = side.WriteBatcher(side.Context("osd.99", overrides=conf),
                           entity="osd.99", **side.kw)
    wb.start()
    return wb


# -- the write batcher's scenarios: each returns (outputs, stats) ------------

def wb_window(side):
    wb = _wb(side, ec_batch_window_ms=200.0)
    try:
        (x,) = _stripes(1)
        t0 = time.monotonic()
        out = wb.encode_chunks(side.mat84, x, side.key84)
        assert time.monotonic() - t0 < 5.0
        return [out], wb.stats()
    finally:
        wb.stop()


def wb_size_cap(side):
    wb = _wb(side, ec_batch_max_stripes=4)
    try:
        outs, errs = _threads(lambda x: wb.encode_chunks(side.mat84, x), _stripes(4))
        assert errs == [None] * 4
        return outs, wb.stats()
    finally:
        wb.stop()


def wb_byte_cap(side):
    xs = _stripes(4)
    wb = _wb(side, ec_batch_max_bytes=2 * xs[0].nbytes)
    try:
        t0 = time.monotonic()
        outs, errs = _threads(lambda x: wb.encode_chunks(side.mat84, x), xs)
        assert time.monotonic() - t0 < 5.0, "waited the 10 s window"
        assert errs == [None] * 4
        return outs, wb.stats()
    finally:
        wb.stop()


def wb_demux(side, pool=True):
    xs = _stripes(12, seed=11)
    wb = _wb(side, ec_batch_max_stripes=12, ec_device_pool=pool)
    try:
        tickets = [wb.encode_submit(side.mat84, x, side.key84) for x in xs]
        return [wb.encode_wait(t) for t in tickets], wb.stats()
    finally:
        wb.stop()


def wb_mixed_geometry(side):
    rng = np.random.default_rng(3)
    items = [(side.mat84, rng.integers(0, 256, (8, 512), np.uint8)),
             (side.mat84, rng.integers(0, 256, (8, 256), np.uint8)),
             (MAT21, rng.integers(0, 256, (2, 512), np.uint8))]
    wb = _wb(side, ec_batch_max_stripes=3)
    try:
        outs, errs = _threads(lambda it: wb.encode_chunks(*it), items)
        assert errs == [None] * 3
        return outs, wb.stats()
    finally:
        wb.stop()


def wb_oversize(side):
    """The delayed first flush lets 7 stripes pile up behind it; the
    second flush is one group over the 2-stripe byte cap, split into
    device batches of 2 stripes through stream_encode."""
    xs = _stripes(8)
    side.fp.registry().set("osd.write_batcher.flush", "times(1,delay(0.3))")
    wb = _wb(side, ec_batch_window_ms=50.0, ec_batch_max_bytes=2 * xs[0].nbytes)
    try:
        first = {}
        t = threading.Thread(
            target=lambda: first.setdefault(0, wb.encode_chunks(side.mat84, xs[0])))
        t.start()
        time.sleep(0.15)  # the first stripe is inside the delayed flush now
        tickets = [wb.encode_submit(side.mat84, x) for x in xs[1:]]
        outs = [wb.encode_wait(p) for p in tickets]
        t.join(timeout=10.0)
        return [first[0]] + outs, wb.stats()
    finally:
        wb.stop()


def wb_error(side):
    side.fp.registry().set("osd.write_batcher.flush", "times(1,error)")
    xs = _stripes(3)
    wb = _wb(side, ec_batch_max_stripes=3)
    try:
        outs, errs = _threads(lambda x: wb.encode_chunks(side.mat84, x), xs)
        assert all(isinstance(e, side.fp.FailpointError) for e in errs), errs
        assert outs == [None] * 3
        assert wb.stats()["flushes"] == 0
        # the failpoint is exhausted: the next batch encodes fine
        return [wb.encode_chunks(side.mat84, xs[0])], wb.stats()
    finally:
        wb.stop()


def wb_crash(side):
    side.fp.registry().set("osd.write_batcher.flush", "times(1,crash)")
    (x,) = _stripes(1)
    wb = _wb(side)
    try:
        with pytest.raises(side.fp.FailpointError):
            wb.encode_chunks(side.mat84, x)
        assert not wb.coalescing()
        return [wb.encode_chunks(side.mat84, x)], wb.stats()
    finally:
        wb.stop()


def wb_shutdown(side):
    wb = _wb(side)
    (x,) = _stripes(1)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(0, wb.encode_chunks(side.mat84, x)))
    t.start()
    deadline = time.monotonic() + 5.0
    while wb.queue_depth() == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert wb.queue_depth() == 1
    wb.stop()  # shutdown flush, not abandonment
    t.join(timeout=10.0)
    return [got[0], wb.encode_chunks(side.mat84, x)], wb.stats()


WRITE_CASES = {
    "window": wb_window, "size_cap": wb_size_cap, "byte_cap": wb_byte_cap,
    "demux_pooled": wb_demux, "demux_pool_off": lambda s: wb_demux(s, pool=False),
    "mixed_geometry": wb_mixed_geometry, "oversize_split": wb_oversize,
    "error_fails_batch": wb_error, "crash_latch": wb_crash,
    "shutdown": wb_shutdown,
}
#: device_batches the port's flushes issue in each case (one apply per
#: (matrix, L) group, one per device batch of a split group)
DEVICE_BATCHES = {"window": 1, "size_cap": 1, "demux_pooled": 1,
                  "demux_pool_off": 1, "mixed_geometry": 3, "oversize_split": 5,
                  "error_fails_batch": 1, "crash_latch": 0, "shutdown": 1}
#: counts that depend on thread timing under a byte cap: how many of the
#: concurrent ops arrive before the flusher takes the queue
TIMED = ("flushes", "device_batches", "decode_groups")


def _untimed(stats):
    return {k: v for k, v in stats.items() if k not in TIMED}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_batcher_matches_reference(case):
    ref_outs, ref_stats = WRITE_CASES[case](REF)
    outs, stats = WRITE_CASES[case](PORT)
    assert len(outs) == len(ref_outs)
    for got, want in zip(outs, ref_outs):
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    if case == "byte_cap":
        assert stats["device_batches"] >= max(2, stats["flushes"])
        stats, ref_stats = _untimed(stats), _untimed(ref_stats)
    else:
        assert stats.pop("device_batches") == DEVICE_BATCHES[case]
    assert stats == ref_stats


def test_write_batcher_parity_equals_numpy_codec():
    """The demux case's parity against the numpy reference codec too."""
    outs, _ = wb_demux(PORT)
    for x, got in zip(_stripes(12, seed=11), outs):
        np.testing.assert_array_equal(got, ref_encode(REF_CODEC.coding, x))


# -- the read batcher --------------------------------------------------------

class FakeIO:
    """In-memory rb_* adapter (the reference tests' shape): one 'local' OSD
    served from the store directly, every other OSD answered through the
    multi-read reply shape of the wire handler."""

    def __init__(self, pack, local=0, down=()):
        self.pack = pack
        self.local = local
        self.down = set(down)
        self.store = {}   # (osd, pgid, shard, oid) -> (bytes, ver, size)
        self.sends = []   # one entry per multi-read sub-op sent
        self.eio = set()  # (osd, oid) whose shard answers EIO
        self._tid = 0
        self._pending = {}

    def put(self, osd, pgid, shard, oid, chunk, ver=1):
        self.store[(osd, pgid, shard, oid)] = (bytes(chunk), ver, len(chunk))

    def rb_local_osd(self):
        return self.local

    def rb_is_up(self, osd):
        return osd not in self.down

    def rb_epoch(self):
        return 7

    def rb_reply_timeout(self):
        return 5.0

    def rb_read_local(self, pgid, shard, oid, off, ln):
        ent = self.store.get((self.local, pgid, shard, oid))
        if ent is None:
            return None
        b, ver, size = ent
        if off is not None:
            b = b[off:off + ln]
            if len(b) != ln:
                return None
        return (b, ver, size)

    def rb_send_multiread(self, osd, pgid, shard, reads, epoch):
        self._tid += 1
        self.sends.append((osd, pgid, shard, [list(r) for r in reads]))
        rows = []
        for oid, off, ln in reads:
            ent = self.store.get((osd, pgid, shard, oid))
            if (osd, oid) in self.eio or ent is None:
                rows.append([-5 if ent else -2, None, None, None])
                continue
            b, ver, size = ent
            if off is not None:
                b = b[off:off + ln]
            rows.append([0, self.pack(b), size, ver])
        self._pending[self._tid] = SimpleNamespace(results=rows)
        return self._tid

    def rb_wait_multireads(self, tids, deadline):
        return {t: self._pending.pop(t) for t in tids if t in self._pending}


def _rb(side, io, **overrides):
    conf = {"osd_read_batch_window_ms": 10_000.0, "osd_read_batch_max_ops": 10_000,
            "osd_read_batch_max_bytes": 1 << 30}
    conf.update(overrides)
    rb = side.ReadBatcher(side.Context("osd.99", overrides=conf), io=io,
                          entity="osd.99", **side.kw)
    rb.start()
    return rb


def _degraded(side, seed, lose, width=512, window=None):
    """A degraded RS(8,4) stripe: (data window, dm, dm_key, survivor stack
    window) where dm @ stack must give back the data window."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (8, width), dtype=np.uint8)
    full = np.vstack([x, ref_encode(REF_CODEC.coding, x)])
    rows = tuple(r for r in range(12) if r not in set(lose))[:8]
    dm, dm_key = side.decode_entry(rows)
    c0, c1 = window or (0, width)
    return x[:, c0:c1], dm, dm_key, np.ascontiguousarray(full[list(rows), c0:c1])


def _decodes(rb, cases):
    outs, errs = _threads(lambda c: rb.decode(c[1], c[3], c[2]), cases)
    assert errs == [None] * len(cases), errs
    for (want, _, _, _), got in zip(cases, outs):
        np.testing.assert_array_equal(got, want)
    return outs


def rb_window_gather(side):
    io = FakeIO(side.pack, local=0)
    io.put(0, "1.0", 0, "a", b"L" * 64)
    io.put(1, "1.0", 1, "a", b"R" * 64, ver=3)
    rb = _rb(side, io, osd_read_batch_window_ms=200.0)
    try:
        res = rb.gather("1.0", [0, 1], [side.ReadReq(0, "a"), side.ReadReq(1, "a")],
                        est_bytes=128)
        return [res, io.sends], rb.stats()
    finally:
        rb.stop()


def rb_op_cap_fanout(side):
    io = FakeIO(side.pack, local=99)  # everything remote
    oids = [f"o{i}" for i in range(4)]
    for oid in oids:
        io.put(1, "1.0", 0, oid, oid.encode() * 16)
        io.put(2, "1.0", 1, oid, oid.encode()[::-1] * 16)
    rb = _rb(side, io, osd_read_batch_max_ops=4)
    try:
        outs, errs = _threads(lambda oid: rb.gather(
            "1.0", [1, 2], [side.ReadReq(0, oid), side.ReadReq(1, oid)], est_bytes=64), oids)
        assert errs == [None] * 4
        return [outs, sorted(len(rows) for *_, rows in io.sends)], rb.stats()
    finally:
        rb.stop()


def rb_gather_faults(side):
    io = FakeIO(side.pack, local=0, down={3})
    io.put(0, "1.0", 0, "a", bytes(range(64)))
    io.put(1, "1.0", 1, "a", bytes(range(64, 128)), ver=9)
    io.put(2, "1.0", 2, "eio-obj", b"z" * 64)
    io.eio.add((2, "eio-obj"))
    rb = _rb(side, io, osd_read_batch_max_ops=1)
    R = side.ReadReq
    try:
        res = rb.gather("1.0", [0, 1, 2, 3], [
            R(0, "a", off=8, ln=4), R(1, "a", off=0, ln=2), R(2, "eio-obj"),
            R(3, "a"), R(1, "absent"), R(0, "a", off=62, ln=8)], est_bytes=64)
        return [res], rb.stats()
    finally:
        rb.stop()


def rb_byte_cap(side):
    cases = [_degraded(side, s, lose=(1,)) for s in range(4)]
    rb = _rb(side, FakeIO(side.pack), osd_read_batch_max_bytes=2 * cases[0][3].nbytes)
    try:
        return _decodes(rb, cases), rb.stats()
    finally:
        rb.stop()


def rb_grouped_decode(side, pool=True):
    """Variable widths under one decode matrix fuse into one group; a
    second survivor set forms its own group."""
    cases = [_degraded(side, s, lose=(1, 4, 9, 11), width=256 + 64 * s) for s in range(3)]
    cases.append(_degraded(side, 9, lose=(0, 11)))
    rb = _rb(side, FakeIO(side.pack), osd_read_batch_max_ops=4, ec_device_pool=pool)
    try:
        return _decodes(rb, cases), rb.stats()
    finally:
        rb.stop()


def rb_ranged_decode(side):
    """Ranged degraded reads: each op decodes only its column window of
    the survivors (inside one chunk, a whole chunk, a ragged tail)."""
    windows = [(100, 150), (0, 1024), (476, 576), (918, 928), (1000, 1024)]
    cases = [_degraded(side, 20 + i, lose=(2, 5, 8, 10), width=1024, window=w)
             for i, w in enumerate(windows)]
    rb = _rb(side, FakeIO(side.pack), osd_read_batch_max_ops=len(cases))
    try:
        return _decodes(rb, cases), rb.stats()
    finally:
        rb.stop()


def rb_mixed(side):
    case = _degraded(side, 5, lose=(1,))
    io = FakeIO(side.pack, local=0)
    io.put(0, "1.0", 0, "g", b"G" * 128)
    rb = _rb(side, io, osd_read_batch_max_ops=2)
    try:
        items = [lambda: rb.gather("1.0", [0], [side.ReadReq(0, "g")], est_bytes=128),
                 lambda: rb.decode(case[1], case[3], case[2])]
        outs, errs = _threads(lambda f: f(), items)
        assert errs == [None, None]
        return outs, rb.stats()
    finally:
        rb.stop()


def rb_error(side):
    cases = [_degraded(side, s, lose=(1,)) for s in range(3)]
    side.fp.registry().set("osd.read_batcher.gather", "times(1,error)")
    rb = _rb(side, FakeIO(side.pack), osd_read_batch_max_ops=3)
    try:
        outs, errs = _threads(lambda c: rb.decode(c[1], c[3], c[2]), cases)
        assert all(isinstance(e, side.fp.FailpointError) for e in errs), errs
        assert outs == [None] * 3
        assert rb.stats()["flushes"] == 0
        want, dm, key, stack = cases[0]
        return [rb.decode(dm, stack, key)], rb.stats()
    finally:
        rb.stop()


def rb_crash(side):
    side.fp.registry().set("osd.read_batcher.gather", "times(1,crash)")
    io = FakeIO(side.pack, local=0)
    io.put(0, "1.0", 0, "a", b"a" * 16)
    rb = _rb(side, io, osd_read_batch_window_ms=50.0)
    try:
        with pytest.raises(side.fp.FailpointError):
            rb.gather("1.0", [0], [side.ReadReq(0, "a")], est_bytes=16)
        assert not rb.coalescing()
        return [rb.gather("1.0", [0], [side.ReadReq(0, "a")], est_bytes=16)], rb.stats()
    finally:
        rb.stop()


def rb_shutdown(side):
    case = _degraded(side, 3, lose=(4,))
    rb = _rb(side, FakeIO(side.pack))
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(0, rb.decode(case[1], case[3], case[2])))
    t.start()
    deadline = time.monotonic() + 5.0
    while rb.queue_depth() == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert rb.queue_depth() == 1
    rb.stop()  # shutdown flush, not abandonment
    t.join(timeout=10.0)
    return [got[0], rb.decode(case[1], case[3], case[2])], rb.stats()


READ_CASES = {
    "window_gather": rb_window_gather, "op_cap_fanout": rb_op_cap_fanout,
    "gather_faults": rb_gather_faults, "byte_cap": rb_byte_cap,
    "grouped_decode": rb_grouped_decode,
    "grouped_decode_pool_off": lambda s: rb_grouped_decode(s, pool=False),
    "ranged_decode": rb_ranged_decode, "mixed": rb_mixed,
    "error_fails_batch": rb_error, "crash_latch": rb_crash, "shutdown": rb_shutdown,
}


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_read_batcher_matches_reference(case):
    ref_outs, ref_stats = READ_CASES[case](REF)
    outs, stats = READ_CASES[case](PORT)
    _same(outs, ref_outs)
    if case == "byte_cap":
        assert stats["decode_groups"] == stats["flushes"] >= 1
        stats, ref_stats = _untimed(stats), _untimed(ref_stats)
    assert stats == ref_stats


# -- the option tables -------------------------------------------------------

SLICE_OPTIONS = (
    "ec_batch_window_ms", "ec_batch_max_stripes", "ec_batch_max_bytes",
    "ec_batch_client_max_share", "osd_read_batch_window_ms",
    "osd_read_batch_max_ops", "osd_read_batch_max_bytes", "osd_read_cache_bytes",
    "osd_read_cache_promote_ops", "ec_device_pool", "ec_device_pool_max_bytes",
    "failpoint", "kernel_telemetry", "trace_enabled", "lockdep", "log_ring_size",
    "admin_socket")


@pytest.mark.parametrize("name", SLICE_OPTIONS)
def test_option_matches_reference(name):
    ours, theirs = default_options().get(name), ref_options().get(name)
    assert (ours.name, ours.type, ours.default) == (theirs.name, theirs.type, theirs.default)

