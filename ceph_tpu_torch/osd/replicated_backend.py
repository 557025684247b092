"""Primary-copy replication (reference: src/osd/ReplicatedBackend.cc).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations




from ..common.crc32c import crc32c
from ..common.tracer import TRACER, trace_now
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpWrite,
    MOSDOp,
    MOSDOpReply,
    pack_data,
    unpack_data,
)
from .pg import CLONE_SEP
from .pg_log import LogEntry


class ReplicatedBackendMixin:
    # .. replicated pool ...................................................
    def _replicated_op(self, pg, pool, acting, msg) -> MOSDOpReply:
        """Primary-copy replication (reference: ReplicatedBackend): full
        object bytes to every acting replica, same log machinery."""
        acting = [o for o in acting if o >= 0]
        my_shard = 0  # replicated: every replica stores the full object
        cid = self._cid(pg.pgid, 0)
        if msg.op in ("write_full", "write", "append", "delete"):
            # min_size gate, as on the EC path
            reachable = sum(
                1 for o in acting
                if o == self.id or self.osdmap.is_up(o)
            )
            if reachable < pool.min_size:
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result=f"{reachable} replicas reachable < "
                           f"min_size {pool.min_size}",
                )
        if msg.op in ("write", "append"):
            # ranged write / append: splice into the primary's copy (the
            # primary always holds the authoritative full object on a
            # replicated pool) and replicate the result full-object —
            # the reference ships op-level deltas; full-object keeps the
            # one replication path here while the EC pool carries the
            # real RMW machinery.  The read-splice-replicate sequence
            # runs under pg.lock (reentrant) so two concurrent appends
            # cannot both read the same old length and lose one update;
            # the rebuilt op KEEPS the reqid so the logged entry still
            # answers cross-primary resends.
            with pg.lock:
                new = unpack_data(msg.data) or b""
                try:
                    old = bytes(self.store.read(cid, msg.oid))
                except (NotFound, KeyError):
                    old = b""
                off = len(old) if msg.op == "append" else int(msg.off or 0)
                buf = bytearray(max(len(old), off + len(new)))
                buf[:len(old)] = old
                buf[off:off + len(new)] = new
                msg = MOSDOp(
                    tid=msg.tid, pool=msg.pool, oid=msg.oid,
                    op="write_full", data=pack_data(bytes(buf)),
                    epoch=msg.epoch, ps=msg.ps,
                    reqid=getattr(msg, "reqid", None),
                )
                return self._replicated_op(pg, pool, acting, msg)
        if msg.op == "write_full":
            data = unpack_data(msg.data) or b""
            # cache-tier pools: the clean-marker clear must ride THIS
            # mutation's transaction + sub-ops, not a separate staging
            # check (advisor r4 — the separate check races the flush's
            # clean-mark and an evict then drops the only copy)
            autoclean = self._tier_autoclean(pool, msg.oid)
            rmattrs = ["tier.clean"] if autoclean else None
            with pg.lock:
                version = pg.version + 1
                entry = LogEntry(version, "modify", msg.oid,
                                 reqid=getattr(msg, "reqid", None))
                tids = {}
                # subop span opens BEFORE the fan-out (see _ec_write)
                sub_span = TRACER.begin(self._op_trace_ctx(), "subop",
                                        entity=self.whoami) \
                    if TRACER.enabled else None
                t_sub0 = sub_span.t0 if sub_span is not None else trace_now()
                for osd in acting:
                    if osd == self.id or not self.osdmap.is_up(osd):
                        continue
                    tid = self._next_tid()
                    tids[tid] = osd
                    try:
                        self._conn_to_osd(osd).send_message(
                            MECSubOpWrite(
                                tid=tid, pgid=pg.pgid, oid=msg.oid, shard=0,
                                data=msg.data, crc=crc32c(data),
                                version=version,
                                entry=entry.to_list(),
                                epoch=self.my_epoch(), osize=len(data),
                                rmattrs=rmattrs,
                                trace_id=(sub_span.trace_id
                                          if sub_span is not None else None),
                                parent_span=(sub_span.span_id
                                             if sub_span is not None
                                             else None),
                            )
                        )
                    except (OSError, ConnectionError):
                        tids.pop(tid, None)
                t = Transaction()
                t.try_create_collection(cid)
                t.write(cid, msg.oid, 0, data)
                t.truncate(cid, msg.oid, len(data))
                # self-digest so scrub can tell at-rest rot on the primary
                # from divergence (replicas get theirs via sub-write)
                t.setattr(cid, msg.oid, "hinfo", str(crc32c(data)).encode())
                t.setattr(cid, msg.oid, "size", str(len(data)).encode())
                t.setattr(cid, msg.oid, "ver", str(version).encode())
                if autoclean:
                    self._txn_clear_clean(t, cid, msg.oid)
                self._log_txn(t, cid, pg, entry)
                t_c0 = trace_now()
                self.store.queue_transaction(t)
                self._op_stage("commit", t_c0, trace_now(),
                               version=version)
                a, deposed, _f = self._collect_subop_acks(tids)
                self._op_stage("subop", t_sub0, trace_now(), span=sub_span,
                               fanout=len(tids), acked=a)
                acked = 1 + a
                if deposed and acked < pool.min_size:
                    return MOSDOpReply(tid=msg.tid, retval=-116,
                                       epoch=self.my_epoch(),
                                       result={"deposed": True})
                if acked >= pool.min_size:
                    return MOSDOpReply(
                        tid=msg.tid, retval=0, epoch=self.my_epoch(),
                        result={"version": pg.version, "acked": acked},
                    )
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result={"applied": pg.version, "acked": acked,
                            "error": "below min_size commits"})
        if msg.op == "read":
            try:
                data = self.store.read(cid, msg.oid)
            except (NotFound, KeyError):
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(), result="not found")
            if msg.off or (msg.length or 0) > 0:
                off = msg.off or 0
                ln = msg.length if msg.length else len(data) - off
                data = data[off : off + ln]
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               data=pack_data(data), result={})
        if msg.op == "delete":
            with pg.lock:
                version = pg.version + 1
                entry = LogEntry(version, "delete", msg.oid,
                                 reqid=getattr(msg, "reqid", None))
                for osd in acting:
                    if osd == self.id or not self.osdmap.is_up(osd):
                        continue
                    tid = self._next_tid()
                    try:
                        self._conn_to_osd(osd).send_message(
                            MECSubOpWrite(
                                tid=tid, pgid=pg.pgid, oid=msg.oid, shard=0,
                                data=None, crc=None, version=version,
                                entry=entry.to_list(), epoch=self.my_epoch(),
                            )
                        )
                    except (OSError, ConnectionError):
                        pass
                t = Transaction()
                t.try_create_collection(cid)
                try:
                    self.store.stat(cid, msg.oid)
                    t.remove(cid, msg.oid)
                except (NotFound, KeyError):
                    pass
                self._log_txn(t, cid, pg, entry)
                self.store.queue_transaction(t)
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={})
        if msg.op == "stat":
            try:
                st = self.store.stat(cid, msg.oid)
                return MOSDOpReply(tid=msg.tid, retval=0,
                                   epoch=self.my_epoch(), result=st)
            except (NotFound, KeyError):
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(), result="not found")
        if msg.op == "list":
            oids = sorted(
                o for o in self.store.list_objects(cid)
                if not o.startswith("_") and CLONE_SEP not in o
            )
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"oids": oids})
        if msg.op in ("setxattr", "getxattrs"):
            return self._xattr_op(pg, acting, 0, msg)
        if msg.op.startswith("omap_"):
            return self._omap_op(pg, pool, acting, msg)
        if msg.op == "exec":
            return self._exec_op(pg, pool, acting, msg)
        if msg.op in ("watch", "unwatch", "notify"):
            return self._watch_op(pg, pool, msg)
        return MOSDOpReply(tid=msg.tid, retval=-22, epoch=self.my_epoch(),
                           result=f"bad op {msg.op}")

