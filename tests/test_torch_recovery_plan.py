"""Why a rebuild's planned repair read gives way to the broad gather is
counted by reason on the rebuilding OSD (``OSD.plan_bailouts``) and
logged.  In a CLAY(8,4,d=11) cluster whose OSD comes back with an empty
store, the retried rebuilds that took the broad gather all counted "a
planned helper is silent": a recovery pass that began before the OSD
was killed had its peer query answered by the old OSD, and its planned
reads then met the new, empty one (ENOENT); the broad gather is the
designed answer to that.  This holds the counter to such a case: one
helper answers EIO, the rebuild gathers broadly and its bytes are
right."""
from __future__ import annotations

import numpy as np

from ceph_tpu_torch.common.failpoint import registry as fp_registry
from ceph_tpu_torch.osd.osdmap import object_ps
from ceph_tpu_torch.qa.vstart import LocalCluster


def _rebuild(c, pid: int, oid: str, lost_of, helper_of):
    """Rebuild one shard of `oid` on its PG's primary with the failpoint
    on `helper_of(acting)`'s reads: (primary OSD, lost shard, chunk,
    the shard as stored, bail-out counts)."""
    m = c._leader().osdmon.osdmap
    ps = object_ps(oid, m.pools[pid].pg_num)
    _up, _upp, acting, primary = m.pg_to_up_acting_osds(pid, ps)
    osd = c.osds[primary]
    lost = lost_of(acting, primary)
    helper = helper_of(acting, primary, lost)
    pool = osd.osdmap.pools[pid]
    pg = osd._pg(pid, ps)
    codec = osd._codec_for_pool(pool)
    stored = bytes(c.osds[acting[lost]].store.read(f"{pid}.{ps}s{lost}", oid))
    fp_registry().set("osd.ec.shard_read", "error",
                      match={"entity": f"osd.{acting[helper]}", "oid": oid})
    try:
        before = dict(osd.plan_bailouts)
        chunk, _size = osd._rebuild_shard_chunk(pg, codec, list(acting), oid, lost, True)
    finally:
        fp_registry().set("osd.ec.shard_read", "off")
    counts = {k: v - before.get(k, 0) for k, v in osd.plan_bailouts.items()}
    return chunk, stored, {k: v for k, v in counts.items() if v}


def test_a_silent_helper_sends_the_rebuild_to_the_broad_gather_and_is_counted():
    with LocalCluster(n_mons=1, n_osds=6, device="cpu") as c:
        c.create_ec_pool("plan", k=4, m=2, pg_num=4, plugin="clay",
                         extra_profile={"d": "5"})
        client = c.client()
        io = client.open_ioctx("plan")
        pid = client.pool_id("plan")
        data = np.random.default_rng(5).integers(0, 256, 64 << 10, np.uint8).tobytes()
        io.write_full("obj", data)
        c.wait_clean("plan", timeout=120)

        def lost_of(acting, primary):
            return next(s for s, o in enumerate(acting) if o != primary)

        def quiet(acting, primary, lost):
            return lost  # the failpoint hits no helper

        def silent(acting, primary, lost):
            return next(s for s, o in enumerate(acting) if o != primary and s != lost)

        chunk, stored, counts = _rebuild(c, pid, "obj", lost_of, quiet)
        assert chunk == stored and counts == {}
        chunk, stored, counts = _rebuild(c, pid, "obj", lost_of, silent)
        assert chunk == stored
        assert counts == {"a planned helper is silent": 1}
