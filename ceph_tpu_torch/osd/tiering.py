"""Cache-tier front-end, promote/flush/evict, and the tier agent (reference: PrimaryLogPG::maybe_handle_cache_detail, agent_work).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations




from ..store.object_store import NotFound, Transaction
from .messages import (
    MOSDOp,
    MOSDOpReply,
    pack_data,
)
from ..osd.osdmap import object_ps
from .pg import CLONE_SEP, MUTATING_OPS


class TieringMixin:
    # -- cache tiering (reference: PrimaryLogPG::maybe_handle_cache_detail
    # — promote_object / do_proxy_read / whiteouts — plus the TierAgent
    # flush/evict loop in PrimaryLogPG::agent_work) -----------------------
    #
    # State model (crash-safe by construction): a cache object with the
    # `tier.clean` user xattr is known flushed/promoted-identical to the
    # base copy and may be evicted; an object WITHOUT it is treated as
    # dirty and will be flushed.  Mutations remove the marker BEFORE the
    # data op and flush/promote set it AFTER the content settles, so a
    # crash at any point can only mislabel a clean object as dirty (a
    # harmless re-flush), never a dirty one as clean (which could evict
    # an unflushed write).  The reference carries these as object_info_t
    # FLAG_DIRTY/FLAG_WHITEOUT inside the op transaction; the xattr
    # spelling reuses this repo's replicated-xattr machinery instead.
    # `tier.whiteout` marks a deleted-in-cache stub whose flush deletes
    # the base object.  tier.* xattrs are internal metadata: visible in
    # getxattrs (documented), never copied to the base pool.

    def _tier_client_op(self, pool_id: int, oid: str, op: str,
                        data=None, off: int = 0, length: int = 0):
        """OSD-as-client op against another pool (promote reads, flush
        writes) — targets the named pool directly, the internal analog
        of CEPH_OSD_FLAG_IGNORE_OVERLAY.  Returns the reply or raises
        OSError on timeout/conn failure."""
        m = self.osdmap
        pool = m.pools.get(pool_id) if m else None
        if pool is None:
            raise OSError(f"tier op: no pool {pool_id}")
        ps = object_ps(oid, pool.pg_num)
        _a, primary = self._acting(pool_id, ps)
        if primary < 0:
            raise OSError(f"tier op: pg {pool_id}.{ps} has no primary")
        tid = self._next_tid()
        rep = self._forward_op(primary, MOSDOp(
            tid=tid, pool=pool_id, oid=oid, op=op, data=data,
            epoch=self.my_epoch(), off=off, length=length,
            reqid=f"tier.{self.id}.{tid}" if op in MUTATING_OPS else None,
        ))
        if rep is None:
            raise OSError(f"tier op {op} {oid!r}: no reply")
        return rep

    def _tier_autoclean(self, pool, oid: str) -> bool:
        """True when a mutation of `oid` must clear the tier.clean marker
        ATOMICALLY with its data op (advisor r4: a clean-flag check in the
        staging path races the flush's clean-mark — only a clear inside
        the mutation's own pg.lock transaction closes the window where
        dirty data gets labeled clean and evicted)."""
        if pool is None or pool.tier_of < 0 or pool.cache_mode == "none":
            return False
        return bool(oid) and CLONE_SEP not in oid and \
            not oid.startswith(("_", ":pg:"))

    def _txn_clear_clean(self, t: Transaction, cid: str, oid: str) -> None:
        """Append the primary-local tier.clean removal to a mutation's
        transaction (the replicas get theirs via the sub-op `rmattrs`)."""
        try:
            if "u_tier.clean" in self.store.getattrs(cid, oid):
                t.rmattr(cid, oid, "u_tier.clean")
        except (NotFound, KeyError):
            pass

    def _tier_flag(self, pg, oid: str, flag: str) -> bool:
        cid = self._cid(pg.pgid, 0)
        try:
            return self.store.getattr(cid, oid, f"u_tier.{flag}") == b"1"
        except (NotFound, KeyError):
            return False

    def _tier_mark(self, pg, acting, oid: str, flag: str,
                   value: bool) -> MOSDOpReply:
        """Set/clear a tier.* marker through the replicated xattr path so
        it survives primary failover."""
        return self._xattr_op(pg, acting, 0, MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid, op="setxattr",
            data={f"tier.{flag}": pack_data(b"1") if value else None},
            epoch=self.my_epoch(),
        ))

    def _cache_tier_op(self, pg, pool, acting, ps, msg, _depth: int = 0):
        """Cache-pool front-end.  Returns a final MOSDOpReply, or None to
        fall through to normal execution (object staged in the cache).

        A promote that aborts because the object appeared concurrently
        (rc == 1, see _tier_promote's race contract) restarts the whole
        decision: the staged object changes every branch below."""
        base_id = pool.tier_of
        m = self.osdmap
        base_pool = m.pools.get(base_id) if m else None
        oid = msg.oid
        if (
            base_pool is None or not oid or CLONE_SEP in oid
            or oid.startswith(":pg:")
            or msg.op in ("list", "watch", "unwatch", "notify")
            or getattr(msg, "ps", None) is not None  # internal machinery
        ):
            return None

        def retry():
            if _depth >= 3:
                return MOSDOpReply(tid=msg.tid, retval=-11,
                                   epoch=self.my_epoch(),
                                   result="tier staging kept racing")
            return self._cache_tier_op(pg, pool, acting, ps, msg,
                                       _depth + 1)

        cid = self._cid(pg.pgid, 0)
        with pg.lock:
            present = self.store.exists(cid, oid)
            whiteout = present and self._tier_flag(pg, oid, "whiteout")

        if msg.op == "cache_flush":
            return self._tier_flush_object(pg, pool, acting, oid, msg.tid)
        if msg.op == "cache_evict":
            return self._tier_evict_object(pg, pool, acting, oid, msg.tid)

        mutating = msg.op in MUTATING_OPS
        if not mutating:
            # reads / stat / getxattrs / omap_get
            if whiteout:
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(),
                                   result="not found (whiteout)")
            if present:
                return None
            if pool.cache_mode == "readproxy":
                # proxy without promoting (reference: do_proxy_read)
                try:
                    rep = self._tier_client_op(
                        base_id, oid, msg.op, data=msg.data,
                        off=msg.off or 0, length=msg.length or 0,
                    )
                except OSError as e:
                    return MOSDOpReply(tid=msg.tid, retval=-11,
                                       epoch=self.my_epoch(),
                                       result=f"proxy read: {e}")
                return MOSDOpReply(tid=msg.tid, retval=rep.retval,
                                   epoch=self.my_epoch(), data=rep.data,
                                   result=rep.result)
            rc = self._tier_promote(pg, pool, acting, base_id, oid,
                                    mark_clean=True)
            if rc == 1:
                return retry()  # raced a write: re-evaluate the staging
            if rc == -2:
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(),
                                   result="not found")
            if rc != 0:
                return MOSDOpReply(tid=msg.tid, retval=-11,
                                   epoch=self.my_epoch(),
                                   result=f"promote failed ({rc})")
            return None  # promoted: serve locally

        # mutations (writeback; readproxy promotes writes too)
        if msg.op == "delete":
            if not present or whiteout:
                # nothing cached (or already whited out): existence is
                # decided by the base copy
                if whiteout:
                    return MOSDOpReply(tid=msg.tid, retval=-2,
                                       epoch=self.my_epoch(),
                                       result="not found (whiteout)")
                try:
                    st = self._tier_client_op(base_id, oid, "stat")
                except OSError as e:
                    return MOSDOpReply(tid=msg.tid, retval=-11,
                                       epoch=self.my_epoch(),
                                       result=f"tier stat: {e}")
                if st.retval != 0:
                    return MOSDOpReply(tid=msg.tid, retval=-2,
                                       epoch=self.my_epoch(),
                                       result="not found")
            # install the whiteout stub: empty object + markers; the
            # agent propagates the delete to the base and retires it
            wrep = self._replicated_op(pg, pool, acting, MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="write_full", data=pack_data(b""),
                epoch=self.my_epoch(), reqid=getattr(msg, "reqid", None),
            ))
            if wrep.retval != 0:
                return MOSDOpReply(tid=msg.tid, retval=wrep.retval,
                                   epoch=self.my_epoch(), result=wrep.result)
            # the stub must shed the pre-delete user state THROUGH THE
            # REPLICATED paths (advisor r4, medium): a primary-local wipe
            # leaves replicas carrying stale xattrs/omap that resurrect
            # after failover, and a delete-then-recreate must never
            # resurrect pre-delete attrs into a later flush
            try:
                stale = {
                    n[2:]: None
                    for n in self.store.getattrs(cid, oid)
                    if n.startswith("u_") and not n[2:].startswith("tier.")
                }
            except (NotFound, KeyError):
                stale = {}
            if stale:
                xrep = self._xattr_op(pg, acting, 0, MOSDOp(
                    tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                    op="setxattr", data=stale, epoch=self.my_epoch(),
                ))
                if xrep.retval != 0:
                    return MOSDOpReply(tid=msg.tid, retval=xrep.retval,
                                       epoch=self.my_epoch(),
                                       result=xrep.result)
            orep = self._omap_op(pg, pool, acting, MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="omap_clear", data={}, epoch=self.my_epoch(),
            ))
            if orep.retval != 0:
                return MOSDOpReply(tid=msg.tid, retval=orep.retval,
                                   epoch=self.my_epoch(), result=orep.result)
            mrep = self._tier_mark(pg, acting, oid, "whiteout", True)
            if mrep.retval != 0:
                return MOSDOpReply(tid=msg.tid, retval=mrep.retval,
                                   epoch=self.my_epoch(), result=mrep.result)
            self._tier_mark(pg, acting, oid, "clean", False)
            return MOSDOpReply(tid=msg.tid, retval=0,
                               epoch=self.my_epoch(), result={})

        if whiteout:
            # write onto a deleted object: never resurrect base bytes —
            # clear the markers and start from the empty stub.  The clear
            # must be DURABLE before the data op: a stale whiteout
            # surviving primary failover would later flush as a delete,
            # destroying the acknowledged write
            mrep = self._tier_mark(pg, acting, oid, "whiteout", False)
            if mrep.retval != 0:
                return MOSDOpReply(tid=msg.tid, retval=-11,
                                   epoch=self.my_epoch(),
                                   result="whiteout clear not durable")
            return None
        if present:
            # the clean-marker clear now rides the mutation's OWN
            # transaction (_tier_autoclean in the write_full / omap /
            # xattr / exec paths), atomically under the same pg.lock —
            # a separate staging clear here raced the flush's clean-mark
            # (advisor r4, medium: flush could label the object clean
            # AFTER this check but BEFORE the data op landed)
            return None
        # absent: partial mutations need the base content staged first;
        # full overwrites don't (reference: proxy/promote decision).  A
        # base miss (rc == -2) just falls through: the normal path gives
        # xattr ops their -2 and creates fresh objects for write/omap,
        # matching un-tiered pool semantics.
        if msg.op not in ("write_full",):
            rc = self._tier_promote(pg, pool, acting, base_id, oid,
                                    mark_clean=False)
            if rc == 1:
                return retry()  # raced a write: re-evaluate the staging
            if rc not in (0, -2):
                return MOSDOpReply(tid=msg.tid, retval=-11,
                                   epoch=self.my_epoch(),
                                   result=f"promote failed ({rc})")
        return None

    def _tier_promote(self, pg, pool, acting, base_id: int, oid: str,
                      mark_clean: bool) -> int:
        """Copy oid (data + user xattrs + omap) from the base pool into
        this cache PG (reference: PrimaryLogPG::promote_object).  Returns
        0, -2 (no base object), 1 (ABORTED: the object appeared locally
        while we read the base copy — the caller re-evaluates its staging
        decision), or a negative errno.

        Race contract (advisor r4, high): the base-pool reads run
        lock-free, but the local existence re-check and the staging
        writes run under pg.lock — a client write that staged fresh data
        concurrently either lands before our locked section (we see it
        and abort: promoting would overwrite acknowledged new data with
        stale base content) or serializes after it (its own transaction
        clears the clean marker we may set)."""
        try:
            rep = self._tier_client_op(base_id, oid, "read")
            if rep.retval == -2:
                return -2
            if rep.retval != 0:
                return rep.retval or -5
            xrep = self._tier_client_op(base_id, oid, "getxattrs")
            xattrs = dict(xrep.result or {}) if xrep.retval == 0 else {}
            orep = self._tier_client_op(base_id, oid, "omap_get")
            kv = dict((orep.result or {}).get("kv") or {}) \
                if orep.retval == 0 else {}
        except OSError:
            return -11
        cid = self._cid(pg.pgid, 0)
        with pg.lock:
            if self.store.exists(cid, oid):
                return 1  # raced a write: fresh data already staged
            wrep = self._replicated_op(pg, pool, acting, MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="write_full", data=rep.data, epoch=self.my_epoch(),
            ))
            if wrep.retval != 0:
                return wrep.retval or -5
            if xattrs:
                self._xattr_op(pg, acting, 0, MOSDOp(
                    tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                    op="setxattr", data=xattrs, epoch=self.my_epoch(),
                ))
            if kv:
                self._omap_op(pg, pool, acting, MOSDOp(
                    tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                    op="omap_set", data={"keys": kv}, epoch=self.my_epoch(),
                ))
            if mark_clean:
                self._tier_mark(pg, acting, oid, "clean", True)
        self.logger.inc("tier_promote")
        return 0

    def _tier_flush_object(self, pg, pool, acting, oid: str,
                           tid: int) -> MOSDOpReply:
        """Flush one cache object to the base pool (reference:
        PrimaryLogPG::start_flush).  Whiteouts propagate the delete and
        retire the stub; dirty objects copy content and gain the clean
        marker — guarded by a version recheck so a write racing the
        flush re-dirties instead of being mislabeled clean."""
        base_id = pool.tier_of
        cid = self._cid(pg.pgid, 0)
        if not self.store.exists(cid, oid):
            return MOSDOpReply(tid=tid, retval=-2, epoch=self.my_epoch(),
                               result="not found")
        if self._tier_flag(pg, oid, "whiteout"):
            try:
                drep = self._tier_client_op(base_id, oid, "delete")
            except OSError as e:
                return MOSDOpReply(tid=tid, retval=-11,
                                   epoch=self.my_epoch(),
                                   result=f"flush delete: {e}")
            if drep.retval not in (0, -2):
                return MOSDOpReply(tid=tid, retval=drep.retval,
                                   epoch=self.my_epoch(), result=drep.result)
            # retire the stub under pg.lock, re-checking the marker: a
            # client write racing this flush clears the whiteout and
            # stages fresh data in the stub — deleting it then would lose
            # an acknowledged write (the re-dirtied object simply flushes
            # again on the next pass, recreating the base copy)
            with pg.lock:
                if not self._tier_flag(pg, oid, "whiteout"):
                    return MOSDOpReply(
                        tid=tid, retval=0, epoch=self.my_epoch(),
                        result={"flushed": "raced a rewrite; kept"})
                rrep = self._replicated_op(pg, pool, acting, MOSDOp(
                    tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                    op="delete", epoch=self.my_epoch(),
                ))
            return MOSDOpReply(tid=tid, retval=rrep.retval,
                               epoch=self.my_epoch(),
                               result={"flushed": "whiteout"})
        if self._tier_flag(pg, oid, "clean"):
            return MOSDOpReply(tid=tid, retval=0, epoch=self.my_epoch(),
                               result={"flushed": "already clean"})
        try:
            ver_before = self.store.getattr(cid, oid, "ver")
        except (NotFound, KeyError):
            ver_before = None
        data = bytes(self.store.read(cid, oid))
        xattrs = {
            n[2:]: pack_data(v)
            for n, v in self.store.getattrs(cid, oid).items()
            if n.startswith("u_") and not n[2:].startswith("tier.")
        }
        kv = self.store.omap_get(cid, oid)
        try:
            wrep = self._tier_client_op(base_id, oid, "write_full",
                                        data=pack_data(data))
            if wrep.retval != 0:
                return MOSDOpReply(tid=tid, retval=wrep.retval,
                                   epoch=self.my_epoch(), result=wrep.result)
            if xattrs:
                self._tier_client_op(base_id, oid, "setxattr", data=xattrs)
            if kv:
                self._tier_client_op(
                    base_id, oid, "omap_set",
                    data={"keys": {k: pack_data(v) for k, v in kv.items()}},
                )
        except OSError as e:
            return MOSDOpReply(tid=tid, retval=-11, epoch=self.my_epoch(),
                               result=f"flush write: {e}")
        with pg.lock:
            try:
                ver_now = self.store.getattr(cid, oid, "ver")
            except (NotFound, KeyError):
                ver_now = None
            if ver_now == ver_before:
                self._tier_mark(pg, acting, oid, "clean", True)
        self.logger.inc("tier_flush")
        return MOSDOpReply(tid=tid, retval=0, epoch=self.my_epoch(),
                           result={"flushed": len(data)})

    def _tier_evict_object(self, pg, pool, acting, oid: str,
                           tid: int) -> MOSDOpReply:
        """Drop a CLEAN cache copy (reference: PrimaryLogPG::_delete_oid
        under agent_maybe_evict); -EBUSY for dirty/whiteout objects."""
        cid = self._cid(pg.pgid, 0)
        with pg.lock:
            if not self.store.exists(cid, oid):
                return MOSDOpReply(tid=tid, retval=-2,
                                   epoch=self.my_epoch(),
                                   result="not found")
            if (
                not self._tier_flag(pg, oid, "clean")
                or self._tier_flag(pg, oid, "whiteout")
            ):
                return MOSDOpReply(tid=tid, retval=-16,
                                   epoch=self.my_epoch(),
                                   result="dirty: flush first")
            rrep = self._replicated_op(pg, pool, acting, MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="delete", epoch=self.my_epoch(),
            ))
        if rrep.retval != 0:
            return MOSDOpReply(tid=tid, retval=rrep.retval,
                               epoch=self.my_epoch(), result=rrep.result)
        self.logger.inc("tier_evict")
        return MOSDOpReply(tid=tid, retval=0,
                           epoch=self.my_epoch(), result={"evicted": oid})

    def _tier_agent_pass(self) -> None:
        """Background flush/evict over primary cache-pool PGs (reference:
        the TierAgent woken by agent_choose_mode).  Flushes every dirty
        object and whiteout; evicts clean objects while the pool is over
        target_max_objects (eviction order is name-sorted — the
        reference ranks by hit_set temperature, out of scope here)."""
        m = self.osdmap
        if m is None:
            return
        for pool in list(m.pools.values()):
            # readproxy pools flush too: their writes stage dirty in the
            # cache exactly like writeback (only reads are proxied)
            if pool.tier_of < 0 or pool.cache_mode == "none":
                continue
            for ps in range(pool.pg_num):
                acting, primary = self._acting(pool.pool_id, ps)
                if primary != self.id:
                    continue
                pg = self._pg(pool.pool_id, ps)
                if pg.activated_interval != pg.interval_start:
                    continue
                cid = self._cid(pg.pgid, 0)
                try:
                    oids = [
                        o for o in self.store.list_objects(cid)
                        if not o.startswith("_") and CLONE_SEP not in o
                    ]
                except (NotFound, KeyError):
                    continue
                live = []
                for oid in sorted(oids):
                    if self._tier_flag(pg, oid, "whiteout") or \
                            not self._tier_flag(pg, oid, "clean"):
                        try:
                            self._tier_flush_object(
                                pg, pool, acting, oid, self._next_tid()
                            )
                        except Exception as e:
                            self.cct.dout(
                                "osd", 5,
                                f"{self.whoami} tier flush {oid}: {e!r}")
                    if self.store.exists(cid, oid):
                        live.append(oid)
                target = pool.target_max_objects
                if target and len(live) > max(0, target // pool.pg_num):
                    for oid in live[max(0, target // pool.pg_num):]:
                        try:
                            self._tier_evict_object(
                                pg, pool, acting, oid, self._next_tid()
                            )
                        except Exception as e:
                            # eviction is opportunistic (the next agent
                            # pass retries), but never silent
                            self.cct.dout(
                                "osd", 5,
                                f"{self.whoami} tier evict {oid}: {e!r}")

