"""The port's Objecter resends an op in flight when a new map moves its
primary (reference: Objecter::_scan_requests).  The copied Objecter
waited out the op's whole 30 s timeout for a reply from an OSD the map
had marked down; under load this left one of the recovery smoke's
writers without a write while the OSD was down
(``qa/recovery_smoke.py``)."""
from __future__ import annotations

import threading
import time

from ceph_tpu_torch.common.failpoint import registry as fp_registry
from ceph_tpu_torch.osd.osdmap import object_ps
from ceph_tpu_torch.qa.vstart import LocalCluster

#: how long the primary holds the op; the client must not wait for it
STALL_S = 12.0


def test_op_in_flight_is_resent_when_a_map_moves_its_primary():
    with LocalCluster(n_mons=1, n_osds=3, device="cpu") as c:
        c.create_ec_pool("resend", k=2, m=1, pg_num=8)
        io = c.client().open_ioctx("resend")
        io.write_full("warm", b"w" * 4096)
        m = c._leader().osdmon.osdmap
        pid = next(i for i, p in m.pools.items() if p.name == "resend")
        oid = "stalled"
        primary = m.pg_to_up_acting_osds(pid, object_ps(oid, m.pools[pid].pg_num))[3]
        # the primary's dispatch holds the client's op: it is in flight
        # when that OSD is killed and marked down
        fp_registry().set("osd.dispatch", f"times(1,delay({STALL_S}))",
                          match={"entity": f"osd.{primary}", "msg": "MOSDOp"})
        try:
            done: dict = {}

            def write() -> None:
                t0 = time.monotonic()
                io.write_full(oid, b"x" * 4096)
                done["s"] = time.monotonic() - t0

            t = threading.Thread(target=write, daemon=True)
            t.start()
            time.sleep(0.5)
            c.kill_osd(primary)
            rv, _ = c.mon_command({"prefix": "osd down", "id": primary})
            assert rv == 0
            t.join(timeout=STALL_S + 30.0)
            assert "s" in done, "the write never completed"
            # resent to the new primary at the map push, not after the
            # op's 30 s timeout
            assert done["s"] < STALL_S / 2, done
            assert io.read(oid) == b"x" * 4096
        finally:
            fp_registry().set("osd.dispatch", "off")


def test_a_refused_op_is_counted_once_when_its_resend_lands(monkeypatch):
    """A write the primary refuses with EAGAIN (here its first attempt,
    as a PG not yet active refuses it) is resent by the Objecter under
    the same reqid; the primary counts the op's bytes once, in the
    aggregate ``op_w_bytes`` and in the client's ``bytes_w`` alike.
    The accounting smoke's "alpha bytes_w == 12 writes" gate failed
    about one run in three when its first write met a peering PG."""
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.osd.messages import MOSDOpReply

    refused = []
    execute = OSD._execute_client_op

    def refuse_first(self, msg):
        if msg.op == "write_full" and not refused:
            refused.append(msg.reqid)
            return MOSDOpReply(tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                               result="peering: pg not active in this interval")
        return execute(self, msg)

    monkeypatch.setattr(OSD, "_execute_client_op", refuse_first)
    with LocalCluster(n_mons=1, n_osds=3, device="cpu",
                      conf_overrides={"osd_client_io_accounting": True}) as c:
        c.create_ec_pool("acct", k=2, m=1, pg_num=4)
        c.client("client.alpha").open_ioctx("acct").write_full("a0", b"a" * 4096)
        assert len(refused) == 1
        wrote = sum(o.logger.get("op_w_bytes") for o in c.osds.values())
        per_client = sum(o.io_acct.totals()["bytes_w"] for o in c.osds.values())
        # the wire carries base64; both counters count its decoded size
        assert wrote == per_client == (4096 + 2) // 3 * 4 * 3 // 4
