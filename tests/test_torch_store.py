"""The port's object stores against the reference's: the cases of
tests/test_store.py and tests/test_bluestore.py, each run through both
packages' MemStore, KStore and BlueStore with the same transactions and
seeded payloads.  Both must give back the same bytes, omaps, xattrs,
errors and fsck results, and write the same files; a KStore or BlueStore
directory written by one package mounts in the other.  The allocator's
native and Python forms are held to each other and to the reference's.
(The objectstore tool and the OSD-on-BlueStore cases wait for the
cluster slice.)
"""
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.store as ref_store
import ceph_tpu.store.alloc as ref_alloc
import ceph_tpu.store.bluestore as ref_bluestore
import ceph_tpu.store.kv as ref_kv
import ceph_tpu_torch.store as port_store
import ceph_tpu_torch.store.alloc as port_alloc
import ceph_tpu_torch.store.bluestore as port_bluestore
import ceph_tpu_torch.store.kv as port_kv

REF = SimpleNamespace(name="reference", store=ref_store, alloc=ref_alloc,
                      bluestore=ref_bluestore, kv=ref_kv)
PORT = SimpleNamespace(name="port", store=port_store, alloc=port_alloc,
                       bluestore=port_bluestore, kv=port_kv)
BACKENDS = ["memstore", "kstore", "bluestore"]


def payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def open_store(P, backend: str, path):
    if backend == "memstore":
        s = P.store.MemStore()
    elif backend == "kstore":
        s = P.store.KStore(str(path))
    else:
        # small device + tiny inline threshold so extent paths are hit
        s = P.bluestore.BlueStore(str(path), device_size=16 << 20, inline_threshold=64)
    s.mount()
    return s


def snapshot(s) -> dict:
    """Everything a store gives back: per object its bytes, stat, xattrs
    and omap."""
    out = {}
    for cid in s.list_collections():
        for oid in s.list_objects(cid):
            out[(cid, oid)] = (bytes(s.read(cid, oid)), s.stat(cid, oid),
                               s.getattrs(cid, oid), s.omap_get(cid, oid))
    return {"collections": s.list_collections(), "objects": out}


def files(path) -> dict:
    """Every file under `path`, by relative name, with its bytes."""
    out = {}
    for root, _dirs, names in os.walk(path):
        for f in names:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return dict(sorted(out.items()))


def outcome(fn):
    """fn()'s value, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the error class is the result
        return type(e).__name__


def _mkcoll(P, s, cid="1.0"):
    s.queue_transaction(P.store.Transaction().create_collection(cid))
    return cid


# ---- the ObjectStore cases (tests/test_store.py::TestObjectStore) ----


def sc_write_read_roundtrip(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    committed = []
    s.queue_transaction(T().write(cid, "obj", 0, b"hello world"),
                        on_commit=lambda: committed.append(1))
    big = payload(1, 50_000)
    s.queue_transaction(T().write(cid, "big", 0, big))
    assert committed == [1]
    assert s.read(cid, "obj") == b"hello world" and s.read(cid, "big") == big
    return [committed, s.read(cid, "obj", 6, 5), s.stat(cid, "obj"),
            bytes(s.read(cid, "big", 4097, 9000))]


def sc_overwrite_extend_zero_truncate(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    steps = [T().write(cid, "o", 0, b"aaaa"), T().write(cid, "o", 2, b"bbbb"),
             T().write(cid, "o", 8, b"cc"), T().zero(cid, "o", 1, 3),
             T().truncate(cid, "o", 4), T().truncate(cid, "o", 6),
             T().write(cid, "o", 5000, payload(2, 7000)), T().zero(cid, "o", 4090, 20),
             T().truncate(cid, "o", 9001)]
    seen = []
    for t in steps:
        s.queue_transaction(t)
        seen.append(bytes(s.read(cid, "o")))
    assert seen[:6] == [b"aaaa", b"aabbbb", b"aabbbb\0\0cc", b"a\0\0\0bb\0\0cc",
                        b"a\0\0\0", b"a\0\0\0\0\0"]
    return seen


def sc_touch_remove_exists(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    s.queue_transaction(T().touch(cid, "o"))
    got = [s.exists(cid, "o"), s.stat(cid, "o")]
    s.queue_transaction(T().remove(cid, "o"))
    got += [s.exists(cid, "o"), outcome(lambda: s.read(cid, "o"))]
    assert got == [True, {"size": 0}, False, "NotFound"]
    return got


def sc_xattr_omap(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    keys = {f"k{i}": payload(10 + i, i * 7) for i in range(12)}
    s.queue_transaction(T().touch(cid, "o").setattr(cid, "o", "hinfo", b"\x01\x02")
                        .omap_setkeys(cid, "o", keys))
    got = [s.getattr(cid, "o", "hinfo"), s.getattrs(cid, "o"), s.omap_get(cid, "o")]
    s.queue_transaction(T().rmattr(cid, "o", "hinfo").omap_rmkeys(cid, "o", ["k1", "k7"]))
    got += [s.getattrs(cid, "o"), s.omap_get(cid, "o")]
    s.queue_transaction(T().omap_clear(cid, "o"))
    got.append(s.omap_get(cid, "o"))
    assert got[0] == b"\x01\x02" and got[3] == {} and got[5] == {}
    return got


def sc_collections(P, s):
    T = P.store.Transaction
    _mkcoll(P, s, "1.0")
    _mkcoll(P, s, "1.1")
    got = [s.list_collections()]
    s.queue_transaction(T().touch("1.0", "a").touch("1.0", "b"))
    got.append(s.list_objects("1.0"))
    got.append(outcome(lambda: s.queue_transaction(T().remove_collection("1.0"))))
    got.append(outcome(lambda: s.queue_transaction(T().create_collection("1.1"))))
    s.queue_transaction(T().remove_collection("1.1"))
    got.append(s.list_collections())
    assert got == [["1.0", "1.1"], ["a", "b"], "StoreError", "StoreError", ["1.0"]]
    return got


def sc_move_rename(P, s):
    T = P.store.Transaction
    _mkcoll(P, s, "1.0")
    _mkcoll(P, s, "1.1")
    s.queue_transaction(T().write("1.0", "temp_recovering", 0, payload(3, 9000))
                        .setattr("1.0", "temp_recovering", "a", b"v"))
    s.queue_transaction(T().collection_move_rename("1.0", "temp_recovering", "1.1", "obj"))
    got = [s.list_objects("1.0"), bytes(s.read("1.1", "obj")), s.getattr("1.1", "obj", "a")]
    assert got[0] == [] and got[1] == payload(3, 9000) and got[2] == b"v"
    return got


def sc_transaction_atomicity_on_failure(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    s.queue_transaction(T().write(cid, "o", 0, b"base"))
    bad = T().write(cid, "o", 0, b"XXXX").setattr(cid, "missing", "a", b"v")
    got = [outcome(lambda: s.queue_transaction(bad)), bytes(s.read(cid, "o"))]
    assert got == ["NotFound", b"base"]  # first op rolled back
    return got


def sc_multi_op_transaction(P, s):
    T = P.store.Transaction
    cid = _mkcoll(P, s)
    s.queue_transaction(T().write(cid, "o", 0, b"0123456789").setattr(cid, "o", "crc", b"x")
                        .omap_setkeys(cid, "o", {"pglog.1": b"entry"})
                        .write(cid, "o2", 0, b"second"))
    got = [s.read(cid, "o"), s.read(cid, "o2")]
    assert got == [b"0123456789", b"second"]
    return got


SCENARIOS = [sc_write_read_roundtrip, sc_overwrite_extend_zero_truncate,
             sc_touch_remove_exists, sc_xattr_omap, sc_collections, sc_move_rename,
             sc_transaction_atomicity_on_failure, sc_multi_op_transaction]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
@pytest.mark.parametrize("backend", BACKENDS)
def test_objectstore_case_matches_reference(backend, scenario, tmp_path):
    results = {}
    for P in (REF, PORT):
        path = tmp_path / P.name
        s = open_store(P, backend, path)
        try:
            results[P.name] = (scenario(P, s), snapshot(s))
            if backend == "bluestore":
                results[P.name] += (s.fsck(deep=True),)
        finally:
            s.umount()
        if backend != "memstore":
            results[P.name] += (files(path),)
    assert results["port"] == results["reference"]


def test_transaction_encode_decode_across_packages():
    def build(T):
        return (T().create_collection("1.0").write("1.0", "o", 4, b"data")
                .zero("1.0", "o", 0, 2).setattr("1.0", "o", "n", b"v")
                .omap_setkeys("1.0", "o", {"k": b"v"})
                .collection_move_rename("1.0", "o", "1.0", "o2"))

    wire = bytes(build(REF.store.Transaction).encode())
    assert bytes(build(PORT.store.Transaction).encode()) == wire
    for P, blob in ((PORT, wire), (REF, bytes(build(PORT.store.Transaction).encode()))):
        rt = P.store.Transaction.decode(blob)
        s2 = P.store.MemStore()
        s2.queue_transaction(rt)
        assert s2.read("1.0", "o2", 0) == b"\0\0\0\0data"


def test_factory(tmp_path):
    S = PORT.store
    assert isinstance(S.create_store("memstore"), S.MemStore)
    assert isinstance(S.create_store("kstore", str(tmp_path / "k")), S.KStore)
    for args in (("bluestore",), ("kstore",)):
        with pytest.raises(S.StoreError):
            S.create_store(*args)
    assert type(S.create_store("bluestore", str(tmp_path / "b"))).__module__ \
        == "ceph_tpu_torch.store.bluestore"


# ---- a store written by one package mounts in the other ----


def _fill(P, s, seed):
    T = P.store.Transaction
    rng = np.random.default_rng(seed)
    s.queue_transaction(T().try_create_collection("2.0").try_create_collection("2.1s3"))
    for i in range(12):
        cid = ["2.0", "2.1s3"][i % 2]
        n = int(rng.integers(0, 60_000))
        t = T().write(cid, f"obj{seed}.{i}", int(rng.integers(0, 5000)), payload(seed + i, n))
        t.setattr(cid, f"obj{seed}.{i}", "hinfo", payload(seed - i, 24))
        t.omap_setkeys(cid, f"obj{seed}.{i}", {f"pglog.{j}": payload(j, 40) for j in range(i)})
        s.queue_transaction(t)
    s.queue_transaction(T().remove("2.0", f"obj{seed}.4").truncate("2.1s3", f"obj{seed}.5", 77))


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("backend", ["kstore", "bluestore", "bluestore_zlib"])
def test_store_mounts_in_the_other_package(backend, writer, reader, tmp_path):
    kind, *comp = backend.split("_")

    def mount(P):
        if kind == "kstore":
            s = P.store.KStore(str(tmp_path / "s"))
        else:
            s = P.bluestore.BlueStore(str(tmp_path / "s"), device_size=16 << 20,
                                      inline_threshold=64, sync=False,
                                      compression=comp[0] if comp else "none")
        s.mount()
        return s

    def check(s):
        return (snapshot(s), s.fsck(deep=True) if kind == "bluestore" else s.fsck())

    a = mount(writer)
    _fill(writer, a, 100)
    want = check(a)
    a.umount()
    b = mount(reader)
    assert check(b) == want
    _fill(reader, b, 200)  # and the other package's writes read back in the first
    want = check(b)
    b.umount()
    a = mount(writer)
    assert check(a) == want
    a.umount()


# ---- KStore persistence and LogKV (tests/test_store.py) ----


def kp_remount_preserves_everything(P, p):
    T, K = P.store.Transaction, P.store.KStore
    s = K(p)
    s.mount()
    s.queue_transaction(T().create_collection("1.0"))
    s.queue_transaction(T().write("1.0", "o", 0, b"persist me")
                        .setattr("1.0", "o", "hinfo", b"\x07")
                        .omap_setkeys("1.0", "o", {"k": b"v"}))
    s.umount()
    s2 = K(p)
    s2.mount()
    got = [s2.read("1.0", "o"), s2.getattr("1.0", "o", "hinfo"), s2.omap_get("1.0", "o"),
           s2.fsck()]
    s2.umount()
    assert got == [b"persist me", b"\x07", {"k": b"v"}, []]
    return got


def kp_wal_replay_without_compaction(P, p):
    T, K = P.store.Transaction, P.store.KStore
    s = K(p)
    s.mount()
    s.queue_transaction(T().create_collection("1.0"))
    for i in range(10):
        s.queue_transaction(T().write("1.0", f"o{i}", 0, bytes([i]) * 10))
    s2 = K(p)  # a crash: no umount, reopen from the files
    s2.mount()
    got = [s2.list_objects("1.0"), s2.read("1.0", "o7")]
    assert len(got[0]) == 10 and got[1] == b"\x07" * 10
    return got


def kp_torn_wal_tail_dropped(P, p):
    T, K = P.store.Transaction, P.store.KStore
    s = K(p)
    s.mount()
    s.queue_transaction(T().create_collection("1.0"))
    s.queue_transaction(T().write("1.0", "good", 0, b"ok"))
    s.umount()
    with open(os.path.join(p, "wal"), "ab") as f:  # a torn half-written record
        f.write(struct.pack("<II", 1000, 0xDEAD) + b"partial")
    s2 = K(p)
    s2.mount()
    got = [s2.read("1.0", "good")]
    s2.queue_transaction(T().write("1.0", "after", 0, b"x"))
    s2.umount()
    s3 = K(p)
    s3.mount()
    got.append(s3.read("1.0", "after"))
    assert got == [b"ok", b"x"]
    return got


def kp_corrupt_record_stops_replay(P, p):
    T, K = P.store.Transaction, P.store.KStore
    s = K(p)
    s.mount()
    s.queue_transaction(T().create_collection("1.0"))
    s.queue_transaction(T().write("1.0", "a", 0, b"first"))
    s.umount()
    wal = os.path.join(p, "wal")
    good = os.path.getsize(wal)
    s = K(p)
    s.mount()
    s.queue_transaction(T().write("1.0", "b", 0, b"second"))
    s.umount()
    with open(wal, "r+b") as f:  # flip a byte inside the second record
        f.seek(good + 12)
        c = f.read(1)
        f.seek(good + 12)
        f.write(bytes([c[0] ^ 0xFF]))
    s2 = K(p)
    s2.mount()
    got = [s2.read("1.0", "a"), s2.exists("1.0", "b")]
    assert got == [b"first", False]
    return got


def kp_compaction_snapshot(P, p):
    T, K = P.store.Transaction, P.store.KStore
    s = K(p)
    s.mount()
    s.queue_transaction(T().create_collection("1.0"))
    for i in range(5):
        s.queue_transaction(T().write("1.0", "o", 0, b"v%d" % i))
    s.compact()
    got = [os.path.getsize(os.path.join(p, "wal"))]
    s.queue_transaction(T().write("1.0", "post", 0, b"after snap"))
    s.umount()
    s2 = K(p)
    s2.mount()
    got += [s2.read("1.0", "o"), s2.read("1.0", "post")]
    assert got == [0, b"v4", b"after snap"]
    return got


def kv_basic_and_iterate(P, p):
    kv = P.store.LogKV(p)
    kv.set("a/1", b"x")
    kv.set("a/2", b"y")
    kv.set("b/1", b"z")
    got = [kv.get("a/1"), kv.get("missing"), list(kv.iterate("a/"))]
    kv.rm("a/1")
    got += [kv.get("a/1"), len(kv)]
    kv.close()
    assert got == [b"x", None, [("a/1", b"x"), ("a/2", b"y")], None, 2]
    return got


def kv_batch_atomic_replay(P, p):
    kv = P.store.LogKV(p)
    kv.submit_batch(P.kv.Batch().set("k1", b"v1").set("k2", b"v2").rm("k1"))
    kv.close()
    kv2 = P.store.LogKV(p)
    got = [kv2.get("k1"), kv2.get("k2")]
    kv2.close()
    assert got == [None, b"v2"]
    return got


def kv_auto_compact_threshold(P, p):
    kv = P.store.LogKV(p, compact_threshold=1000)
    for i in range(100):
        kv.set(f"k{i}", b"x" * 50)
    got = [os.path.getsize(os.path.join(p, "wal")) < 1000]
    kv.close()
    kv2 = P.store.LogKV(p)
    got.append(len(kv2))
    kv2.close()
    assert got == [True, 100]
    return got


@pytest.mark.parametrize("case", [
    kp_remount_preserves_everything, kp_wal_replay_without_compaction,
    kp_torn_wal_tail_dropped, kp_corrupt_record_stops_replay, kp_compaction_snapshot,
    kv_basic_and_iterate, kv_batch_atomic_replay, kv_auto_compact_threshold,
], ids=lambda f: f.__name__)
def test_persistence_case_matches_reference(case, tmp_path):
    results = {}
    for P in (REF, PORT):
        p = str(tmp_path / P.name)
        results[P.name] = (case(P, p), files(p))
    assert results["port"] == results["reference"]


# ---- the allocator (tests/test_bluestore.py) ----


def test_port_builds_the_native_allocator():
    """The port's loader builds native/'s sources outside native/ and the
    allocator binds to it."""
    lib = port_alloc._load_lib()
    assert lib
    assert "build" in lib._name and "native" not in os.path.dirname(lib._name)
    assert isinstance(port_alloc.make_allocator(8), port_alloc.NativeBitmapAllocator)


def alloc_trajectory(cls, AllocError, seed=0):
    """A seeded alloc/release sequence: extents, free counts, exhaustion."""
    a = cls(512)
    rng = np.random.default_rng(seed)
    held, trace = [], []
    for _ in range(80):
        if rng.random() < 0.6 or not held:
            want = int(rng.integers(1, 40))
            try:
                ext = a.allocate(want)
                held.append(ext)
                trace.append(("alloc", want, [tuple(map(int, e)) for e in ext]))
            except AllocError:
                trace.append(("full", want))
        else:
            for st, n in held.pop(int(rng.integers(0, len(held)))):
                a.release(st, n)
        trace.append(a.free_blocks)
    a.mark_used(0, 8)
    a.mark_used(4, 8)
    trace.append(a.free_blocks)
    trace.append(outcome(lambda: a.mark_used(510, 4)))
    return trace


@pytest.mark.parametrize("form", ["NativeBitmapAllocator", "PyBitmapAllocator"])
def test_allocator_matches_reference(form):
    """Each of the port's allocator forms gives the reference's form the
    same extents, counts and errors; the native and Python forms give the
    same free-count trajectory."""
    got = alloc_trajectory(getattr(PORT.alloc, form), PORT.alloc.AllocError)
    assert got == alloc_trajectory(getattr(REF.alloc, form), REF.alloc.AllocError)
    other = "PyBitmapAllocator" if form == "NativeBitmapAllocator" else "NativeBitmapAllocator"
    twin = alloc_trajectory(getattr(PORT.alloc, other), PORT.alloc.AllocError)
    assert [t for t in got if isinstance(t, int)] == [t for t in twin if isinstance(t, int)]


@pytest.mark.parametrize("form", ["NativeBitmapAllocator", "PyBitmapAllocator"])
def test_allocator_contract(form):
    cls, AllocError = getattr(PORT.alloc, form), PORT.alloc.AllocError
    a = cls(128)
    ext = a.allocate(10)
    assert sum(n for _, n in ext) == 10 and a.free_blocks == 118
    for s, n in ext:
        a.release(s, n)
    assert a.free_blocks == 128
    a = cls(16)
    a.allocate(16)
    with pytest.raises(AllocError):
        a.allocate(1)
    a = cls(64)
    first = a.allocate(64)
    for s, n in [(s + off, 4) for s, n in first for off in range(0, n, 8)]:
        a.release(s, min(n, 4))
    free = a.free_blocks
    got = a.allocate(free)  # harvest across fragments
    assert sum(n for _, n in got) == free and len(got) > 1 and a.free_blocks == 0
    a, seen = cls(256), set()
    for _ in range(20):
        for s, n in a.allocate(11):
            assert not seen & set(range(s, s + n))
            seen |= set(range(s, s + n))


# ---- BlueStore (tests/test_bluestore.py) ----


def bs_open(P, path, **kw):
    kw.setdefault("device_size", 8 << 20)
    kw.setdefault("inline_threshold", 128)
    return P.bluestore.BlueStore(str(path), **kw)


def bs_extent_data_roundtrip_and_cow(P, path):
    T = P.store.Transaction
    bs = bs_open(P, path)
    bs.queue_transaction(T().create_collection("1.0"))
    big = bytes(range(256)) * 256  # 64 KiB -> extents
    bs.queue_transaction(T().write("1.0", "obj", 0, big))
    o1 = bs._onodes[("1.0", "obj")]
    got = [bs.read("1.0", "obj") == big, o1.inline, list(o1.extents)]
    free_before = bs._alloc.free_blocks
    bs.queue_transaction(T().write("1.0", "obj", 0, big[::-1]))  # COW
    got += [bs.read("1.0", "obj") == big[::-1], bs._alloc.free_blocks == free_before,
            list(bs._onodes[("1.0", "obj")].extents)]
    bs.queue_transaction(T().remove("1.0", "obj"))
    got.append(bs._alloc.free_blocks - free_before)
    bs.umount()
    assert got[0] and got[1] is None and got[2] and got[3] and got[4]
    assert got[5] != got[2] and got[6] > 0
    return got


def bs_small_objects_inline(P, path):
    T = P.store.Transaction
    bs = bs_open(P, path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", "tiny", 0, b"x" * 100))
    o = bs._onodes[("c", "tiny")]
    got = [o.inline, o.extents, bs.read("c", "tiny")]
    bs.umount()
    assert got == [b"x" * 100, [], b"x" * 100]
    return got


def bs_remount_rebuilds_state_and_freelist(P, path):
    T = P.store.Transaction
    s = bs_open(P, path, inline_threshold=64)
    s.queue_transaction(T().create_collection("p"))
    data = payload(5, 40000)
    s.queue_transaction(T().write("p", "a", 0, data).setattr("p", "a", "k", b"v")
                        .omap_setkeys("p", "a", {"o1": b"w"}))
    used = s.n_blocks - s._alloc.free_blocks
    s.umount()
    s2 = bs_open(P, path, inline_threshold=64)
    got = [s2.read("p", "a") == data, s2.getattr("p", "a", "k"), s2.omap_get("p", "a"),
           s2.n_blocks - s2._alloc.free_blocks, s2.fsck(deep=True)]
    s2.umount()
    assert got[:4] == [True, b"v", {"o1": b"w"}, used] and got[4]["errors"] == []
    return got


def bs_crc_detects_device_corruption(P, path):
    T = P.store.Transaction
    s = bs_open(P, path, inline_threshold=64)
    s.queue_transaction(T().create_collection("p"))
    s.queue_transaction(T().write("p", "a", 0, payload(6, 30000)))
    start, _n = s._onodes[("p", "a")].extents[0]
    s._dev.seek(start * s.block_size + 10)  # flip a byte behind the store's back
    b = s._dev.read(1)
    s._dev.seek(start * s.block_size + 10)
    s._dev.write(bytes([b[0] ^ 0xFF]))
    s._dev.flush()
    got = [outcome(lambda: s.read("p", "a")), s.fsck(deep=True)]
    s.umount()
    assert got[0] == "StoreError" and any("crc" in e for e in got[1]["errors"])
    return got


def bs_fsck_clean_and_leak_repair(P, path):
    T = P.store.Transaction
    bs = bs_open(P, path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", "x", 0, payload(7, 20000)))
    got = [bs.fsck(deep=True)]
    bs._alloc.mark_used(bs.n_blocks - 1, 1)  # leak a block
    got += [bs.fsck(), bs.fsck(repair=True), bs.fsck()]
    bs.umount()
    assert got[0]["errors"] == [] and got[0]["leaked_blocks"] == 0
    assert got[1]["leaked_blocks"] == 1 and got[2].get("repaired") == 1
    assert got[3]["leaked_blocks"] == 0
    return got


def bs_atomicity_on_failed_txn(P, path):
    T = P.store.Transaction
    bs = bs_open(P, path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", "keep", 0, b"K" * 5000))
    free = bs._alloc.free_blocks
    bad = T().write("c", "keep", 0, b"N" * 5000).truncate("c", "missing", 10)
    got = [outcome(lambda: bs.queue_transaction(bad)), bs.read("c", "keep"),
           bs._alloc.free_blocks == free]
    bs.umount()
    assert got == ["NotFound", b"K" * 5000, True]
    return got


def bs_device_full(P, path):
    T = P.store.Transaction
    s = bs_open(P, path, device_size=64 * 4096, inline_threshold=0)
    s.queue_transaction(T().create_collection("c"))
    got = [outcome(lambda: s.queue_transaction(T().write("c", "huge", 0, b"z" * (100 * 4096))))]
    s.queue_transaction(T().write("c", "ok", 0, b"ok" * 1000))  # still usable
    got.append(s.read("c", "ok"))
    s.umount()
    assert isinstance(got[0], str) and got[1] == b"ok" * 1000
    return got


def _zwrite(P, bs, cid, oid, data):
    t = P.store.Transaction()
    t.try_create_collection(cid)
    t.write(cid, oid, 0, data)
    t.truncate(cid, oid, len(data))
    bs.queue_transaction(t)


def _zopen(P, path, **kw):
    return P.bluestore.BlueStore(str(path), device_size=1 << 24, sync=False, **kw)


def bs_compressible_data_saves_blocks(P, path):
    bs = _zopen(P, path, compression="zlib")
    data = b"A" * 300_000
    _zwrite(P, bs, "c", "o", data)
    o = bs._onodes[("c", "o")]
    got = [o.comp, o.clen, sum(n for _, n in o.extents), bytes(bs.read("c", "o")) == data]
    bs.umount()
    bs2 = _zopen(P, path, compression="zlib")
    got += [bytes(bs2.read("c", "o")) == data, bs2.fsck(deep=True)]
    bs2.umount()
    assert got[0] == "zlib" and got[1] < len(data) // 10 and got[2] < 300_000 // 4096
    assert got[3] and got[4] and got[5]["errors"] == []
    return got


def bs_incompressible_data_stays_raw(P, path):
    bs = _zopen(P, path, compression="zlib")
    data = payload(8, 100_000)
    _zwrite(P, bs, "c", "r", data)
    got = [bs._onodes[("c", "r")].comp, bytes(bs.read("c", "r")) == data]
    bs.umount()
    assert got == [None, True]
    return got


def bs_partial_write_on_compressed_object(P, path):
    bs = _zopen(P, path, compression="zlib")
    data = bytearray(b"B" * 200_000)
    _zwrite(P, bs, "c", "p", bytes(data))
    bs.queue_transaction(P.store.Transaction().write("c", "p", 12345, b"PATCH"))
    data[12345:12350] = b"PATCH"
    got = [bytes(bs.read("c", "p")) == bytes(data), bs.fsck(deep=True)]
    bs.umount()
    assert got[0] and got[1]["errors"] == []
    return got


def bs_uncompressed_store_reads_compressed_onodes(P, path):
    bs = _zopen(P, path, compression="zlib")
    _zwrite(P, bs, "c", "x", b"Z" * 150_000)
    bs.umount()
    bs2 = _zopen(P, path)  # compression off
    got = [bytes(bs2.read("c", "x")) == b"Z" * 150_000]
    _zwrite(P, bs2, "c", "y", b"Y" * 150_000)
    got += [bs2._onodes[("c", "y")].comp, bs2.fsck(deep=True)]
    bs2.umount()
    assert got[:2] == [True, None] and got[2]["errors"] == []
    return got


@pytest.mark.parametrize("case", [
    bs_extent_data_roundtrip_and_cow, bs_small_objects_inline,
    bs_remount_rebuilds_state_and_freelist, bs_crc_detects_device_corruption,
    bs_fsck_clean_and_leak_repair, bs_atomicity_on_failed_txn, bs_device_full,
    bs_compressible_data_saves_blocks, bs_incompressible_data_stays_raw,
    bs_partial_write_on_compressed_object, bs_uncompressed_store_reads_compressed_onodes,
], ids=lambda f: f.__name__[3:])
def test_bluestore_case_matches_reference(case, tmp_path):
    results = {}
    for P in (REF, PORT):
        path = tmp_path / P.name
        results[P.name] = (case(P, path), files(path))
    assert results["port"] == results["reference"]
