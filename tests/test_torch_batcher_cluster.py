"""The cluster cases of test_write_batcher.py and test_read_batcher.py
through the port's LocalCluster on the CPU (``device="cpu"``,
``plugin=torch``): concurrent EC writes ride the write batcher, reads
the read batcher, degraded full and ranged reads come back
byte-identical (a chunk-interior range decodes only its window), CLAY
bypasses the window, and the hot-object cache never serves a stale
version.  Each case asserts what the reference's case asserts."""
from __future__ import annotations

import threading

import numpy as np
import pytest

from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.osd.osdmap import object_ps
from ceph_tpu_torch.qa.vstart import LocalCluster

pytestmark = pytest.mark.cluster


def _acting_of(c, pool, oid):
    m = c._leader().osdmon.osdmap
    pid = next(i for i, p in m.pools.items() if p.name == pool)
    ps = object_ps(oid, m.pools[pid].pg_num)
    _up, _upp, acting, primary = m.pg_to_up_acting_osds(pid, ps)
    return acting, primary


def _decode_bytes_in() -> int:
    return TELEMETRY.dump().get("read_batch_decode", {}).get("bytes_in", 0)


def test_cluster_concurrent_ec_writes_coalesce():
    with LocalCluster(n_mons=1, n_osds=4, device="cpu") as c:
        c.create_ec_pool("wb", k=2, m=1, pg_num=4)
        cl = c.client()
        io = cl.open_ioctx("wb")
        payloads = {f"wb-{i}": bytes([i, 255 - i]) * 2048 for i in range(8)}
        ts = [threading.Thread(target=io.write_full, args=(oid, data))
              for oid, data in payloads.items()]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
        for oid, data in payloads.items():
            assert io.read(oid) == data
        # the RMW parity-delta path crosses the batcher too
        io.write("wb-0", b"Z" * 777, off=1000)
        exp = bytearray(payloads["wb-0"])
        exp[1000:1777] = b"Z" * 777
        assert io.read("wb-0") == bytes(exp)
        stripes = sum(o.write_batcher.stats()["stripes"] for o in c.osds.values())
        perf = sum(o.logger.get("ec_batch_stripes") for o in c.osds.values())
        assert stripes >= 9 and perf == stripes
        ot = cl.objecter._op_throttle
        assert isinstance(ot, Throttle)
        assert ot.current == 0
        assert cl.objecter._bytes_throttle.current == 0


def test_cluster_concurrent_reads_coalesce():
    with LocalCluster(n_mons=1, n_osds=4, device="cpu") as c:
        c.create_ec_pool("rb", k=2, m=1, pg_num=4)
        io = c.client().open_ioctx("rb")
        payloads = {f"rb-{i}": bytes([i, 255 - i]) * 2048 for i in range(8)}
        for oid, data in payloads.items():
            io.write_full(oid, data)
        outs = {}
        ts = [threading.Thread(target=lambda o=oid: outs.__setitem__(o, io.read(o)))
              for oid in payloads]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
        assert outs == payloads
        ops = sum(o.read_batcher.stats()["ops"] for o in c.osds.values())
        perf = sum(o.logger.get("read_batcher_ops") for o in c.osds.values())
        assert ops >= 8 and perf == ops
        assert io.read("rb-0", off=1000, length=777) == payloads["rb-0"][1000:1777]


def test_cluster_degraded_ranged_read_bit_identical():
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    conf = {"osd_subop_reply_timeout": 1.5}
    with LocalCluster(n_mons=1, n_osds=6, conf_overrides=conf, device="cpu") as c:
        c.create_ec_pool("rg", k=4, m=2, pg_num=4)
        io = c.client().open_ioctx("rg")
        payload = np.random.default_rng(11).integers(0, 256, 8192, np.uint8).tobytes()
        io.write_full("obj", payload)
        assert io.read("obj") == payload
        acting, primary = _acting_of(c, "rg", "obj")
        victim = next(acting[j] for j in range(4)
                      if acting[j] >= 0 and acting[j] != primary)
        c.kill_osd(victim)
        assert io.read("obj") == payload          # full degraded decode
        L = ErasureCodePluginRegistry.instance().factory(
            {"plugin": "torch", "k": "4", "m": "2"}, device="cpu").get_chunk_size(len(payload))
        off, ln = L + 37, 101                     # interior of chunk 1
        b0 = _decode_bytes_in()
        assert io.read("obj", off=off, length=ln) == payload[off:off + ln]
        ranged_in = _decode_bytes_in() - b0
        assert ranged_in == 4 * ln, (ranged_in, ln, L)
        assert ranged_in < 4 * L
        # a chunk-spanning range takes the full-decode path
        b1 = _decode_bytes_in()
        off2, ln2 = L - 50, 100
        assert io.read("obj", off=off2, length=ln2) == payload[off2:off2 + ln2]
        assert _decode_bytes_in() == b1
        assert io.read("obj", off=len(payload) - 64) == payload[-64:]


def test_cluster_degraded_clay_read_intact():
    conf = {"osd_subop_reply_timeout": 1.5}
    with LocalCluster(n_mons=1, n_osds=6, conf_overrides=conf, device="cpu") as c:
        c.create_ec_pool("cl", k=4, m=2, pg_num=2, plugin="clay")
        io = c.client().open_ioctx("cl")
        payload = bytes(range(256)) * 64          # 16 KiB
        io.write_full("obj", payload)
        acting, primary = _acting_of(c, "cl", "obj")
        victim = next(acting[j] for j in range(4)
                      if acting[j] >= 0 and acting[j] != primary)
        c.kill_osd(victim)
        b0 = _decode_bytes_in()
        assert io.read("obj") == payload
        assert io.read("obj", off=777, length=555) == payload[777:1332]
        assert _decode_bytes_in() == b0           # CLAY takes no ranged decode


def test_cluster_read_cache_hit_and_write_invalidation():
    conf = {"osd_read_cache_bytes": 1 << 20, "osd_read_cache_promote_ops": 0}
    with LocalCluster(n_mons=1, n_osds=4, conf_overrides=conf, device="cpu") as c:
        c.create_ec_pool("hc", k=2, m=1, pg_num=4)
        io = c.client().open_ioctx("hc")
        v1 = b"one" * 1365
        io.write_full("hot", v1)
        assert io.read("hot") == v1               # fill
        assert io.read("hot") == v1               # hit
        assert io.read("hot", off=100, length=50) == v1[100:150]
        hits = sum(o.logger.get("read_cache_hits") for o in c.osds.values())
        inserts = sum(o.read_cache.stats()["inserts"] for o in c.osds.values())
        assert inserts >= 1 and hits >= 2
        v2 = b"two" * 2000
        io.write_full("hot", v2)
        assert io.read("hot") == v2               # never the stale v1
        io.write("hot", b"Z" * 100, off=50)
        exp = bytearray(v2)
        exp[50:150] = b"Z" * 100
        assert io.read("hot") == bytes(exp)
        inval = sum(o.read_cache.stats()["invalidations"] for o in c.osds.values())
        assert inval >= 1
