"""Object metadata surfaces shared by both backends: user xattrs, omap, object classes, watch/notify (reference: PrimaryLogPG::do_osd_ops attr/omap/cls/watch cases).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations


import time

import numpy as np

from ..common.crc32c import crc32c
from ..common.tracer import TRACER, trace_now
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpRead,
    MECSubOpWrite,
    MOSDOpReply,
    MPGQuery,
    MWatchNotify,
    pack_data,
    unpack_data,
)
from ..osd.osdmap import PG_POOL_ERASURE
from .pg import CLONE_SEP
from .pg_log import LogEntry


class ObjectOpsMixin:
    # .. user xattrs (both pool types) .....................................
    def _xattr_op(self, pg, acting, my_shard, msg) -> MOSDOpReply:
        """librados xattr surface (reference: rados_setxattr/getxattrs).
        User attrs live as `u_<name>` on every shard so any future primary
        answers; updates append a pg_log entry so recovery replays them."""
        cid = self._cid(pg.pgid, my_shard)
        if msg.op == "getxattrs":
            try:
                attrs = {
                    n[2:]: pack_data(v)
                    for n, v in self.store.getattrs(cid, msg.oid).items()
                    if n.startswith("u_")
                }
            except (NotFound, KeyError):
                # degraded primary (remap before recovery): any shard that
                # holds the object carries the same user xattrs
                attrs = self._probe_peer_xattrs(pg, acting, msg.oid)
                if attrs is None:
                    return MOSDOpReply(
                        tid=msg.tid, retval=-2, epoch=self.my_epoch(),
                        result="not found",
                    )
            return MOSDOpReply(
                tid=msg.tid, retval=0, epoch=self.my_epoch(), result=attrs
            )
        updates = msg.data or {}
        pool = self.osdmap.pools.get(pg.pool_id)
        # user-xattr content flushes to the base pool: a cache-pool user
        # setxattr re-dirties the object atomically (merged into the SAME
        # update set / sub-ops) and stamps `ver` so the flush's version
        # recheck also sees xattr-only mutations.  Tier-marker updates
        # (tier.*) are the dirty-tracking machinery itself and must not
        # self-trigger.
        user_mutation = any(not n.startswith("tier.") for n in updates)
        stamp_ver = False
        if (user_mutation and self._tier_autoclean(pool, msg.oid)
                and "tier.clean" not in updates):
            updates = dict(updates)
            updates["tier.clean"] = None
            stamp_ver = True
        with pg.lock:
            try:
                self.store.stat(cid, msg.oid)
            except (NotFound, KeyError):
                # no local copy: object missing cluster-wide (-2, final)
                # vs degraded primary pending recovery (-11, retryable)
                if self._probe_peer_xattrs(pg, acting, msg.oid) is None:
                    return MOSDOpReply(
                        tid=msg.tid, retval=-2, epoch=self.my_epoch(),
                        result="not found",
                    )
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result="object not recovered here yet",
                )
            version = pg.version + 1
            entry = LogEntry(version, "attr", msg.oid)
            tids: dict[int, int] = {}
            for shard, osd in enumerate(acting):
                if osd == self.id or osd < 0 or not self.osdmap.is_up(osd):
                    continue
                tid = self._next_tid()
                tids[tid] = shard
                try:
                    self._conn_to_osd(osd).send_message(
                        MECSubOpWrite(
                            tid=tid, pgid=pg.pgid, oid=msg.oid,
                            shard=shard if self._is_ec_pg(pg) else 0,
                            data=None, crc=None, version=version,
                            entry=entry.to_list(), epoch=self.my_epoch(),
                            xattrs=updates,
                        )
                    )
                except (OSError, ConnectionError):
                    tids.pop(tid, None)
            t = Transaction()
            self._apply_xattr_updates(t, cid, msg.oid, updates)
            if stamp_ver:
                t.setattr(cid, msg.oid, "ver", str(version).encode())
            self._log_txn(t, cid, pg, entry)
            self.store.queue_transaction(t)
            self._read_cache_invalidate(pg.pgid, msg.oid)
            a, deposed, _f = self._collect_subop_acks(tids)
            acked = 1 + a
        if deposed and (pool is None or acked < pool.min_size):
            return MOSDOpReply(tid=msg.tid, retval=-116,
                               epoch=self.my_epoch(),
                               result={"deposed": True})
        # same durability bar as write_full: the update must be on enough
        # shards to survive (reference: xattr ops ride the same repop)
        if pool is not None and acked < pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=-11,
                               epoch=self.my_epoch(),
                               result=f"only {acked} shard commits")
        return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                           result={"version": pg.version})

    def _apply_xattr_updates(self, t: Transaction, cid: str, oid: str,
                             updates: dict, snapshot: bool = False) -> None:
        """Apply user-xattr updates {name: b64|None} to a transaction;
        snapshot=True means `updates` is the complete set (recovery) and
        any other u_* attr must go."""
        try:
            existing = {
                n[2:] for n in self.store.getattrs(cid, oid)
                if n.startswith("u_")
            }
        except (NotFound, KeyError):
            existing = set()
        for name, val in updates.items():
            if val is None:
                if name in existing:
                    t.rmattr(cid, oid, f"u_{name}")
            else:
                t.setattr(cid, oid, f"u_{name}", unpack_data(val))
        if snapshot:
            for name in existing - set(updates):
                t.rmattr(cid, oid, f"u_{name}")

    def _probe_peer_xattrs(self, pg, acting, oid: str) -> dict | None:
        """User xattrs for oid from the FRESHEST up shard (degraded
        getxattrs).  Peers are ordered by their pg_log version so a
        just-revived stale shard cannot answer with pre-update attrs;
        metadata-only reads (offsets=[]) keep the object body off the
        wire."""
        is_ec = self._is_ec_pg(pg)
        peers = []  # (version, shard, osd)
        for shard, osd in enumerate(acting):
            if osd < 0 or osd == self.id or not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MPGQuery(tid=tid, pgid=pg.pgid,
                             shard=shard if is_ec else 0,
                             epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid, timeout=5.0)
            peers.append(
                ((rep.version if rep is not None else 0) or 0, shard, osd)
            )
        for _v, shard, osd in sorted(peers, reverse=True):
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpRead(
                        tid=tid, pgid=pg.pgid, oid=oid,
                        shard=shard if is_ec else 0,
                        offsets=[], epoch=self.my_epoch(),
                    )
                )
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid, timeout=5.0)
            if rep is not None and rep.retval == 0:
                return rep.xattrs or {}
        return None

    def _is_ec_pg(self, pg) -> bool:
        pool = self.osdmap.pools.get(pg.pool_id) if self.osdmap else None
        return bool(pool and pool.type == PG_POOL_ERASURE)

    def _ec_write(self, pg, pool, codec, acting, my_shard, msg, data) -> MOSDOpReply:
        n = codec.get_chunk_count()
        # the parity matmul coalesces with concurrent ops' stripes in
        # the write batcher (ec_backend._ec_encode); everything after —
        # version assignment, sub-op fan-out, ack accounting — is
        # strictly per-op, so batching never changes semantics
        enc = self._ec_encode(codec, data)
        version = pg.version + 1
        # entry rides a 4th element (object size) so every shard can answer
        # size/stat even after the primary moves
        entry = LogEntry(version, "modify", msg.oid,
                         reqid=getattr(msg, "reqid", None))
        wire_entry = entry.to_list()
        tids: dict[int, int] = {}
        # subop span opens BEFORE the fan-out so each MECSubOpWrite can
        # carry its id as parent — the replica commit joins THIS node
        sub_span = TRACER.begin(self._op_trace_ctx(), "subop",
                                entity=self.whoami) if TRACER.enabled \
            else None
        t_sub0 = sub_span.t0 if sub_span is not None else trace_now()
        for shard, osd in enumerate(acting):
            if shard == my_shard or osd < 0:
                continue
            if not self.osdmap.is_up(osd):
                continue
            chunk = np.asarray(enc[shard], np.uint8).tobytes()
            tid = self._next_tid()
            tids[tid] = shard
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpWrite(
                        tid=tid, pgid=pg.pgid, oid=msg.oid, shard=shard,
                        data=pack_data(chunk), crc=crc32c(chunk),
                        version=version, entry=wire_entry,
                        epoch=self.my_epoch(), osize=len(data),
                        trace_id=(sub_span.trace_id
                                  if sub_span is not None else None),
                        parent_span=(sub_span.span_id
                                     if sub_span is not None else None),
                    )
                )
            except (OSError, ConnectionError):
                tids.pop(tid, None)
                self.mc.report_failure(osd)
        # local shard commit (chunk + log in one transaction)
        cid = self._cid(pg.pgid, my_shard)
        chunk = np.asarray(enc[my_shard], np.uint8).tobytes()
        t = Transaction()
        t.try_create_collection(cid)
        t.write(cid, msg.oid, 0, chunk)
        t.truncate(cid, msg.oid, len(chunk))
        t.setattr(cid, msg.oid, "hinfo", str(crc32c(chunk)).encode())
        t.setattr(cid, msg.oid, "size", str(len(data)).encode())
        t.setattr(cid, msg.oid, "ver", str(version).encode())
        self._log_txn(t, cid, pg, entry)
        t_c0 = trace_now()
        self.store.queue_transaction(t)
        self._read_cache_invalidate(pg.pgid, msg.oid)
        self._op_stage("commit", t_c0, trace_now(), version=version)
        a, deposed, failed = self._collect_subop_acks(tids, acting)
        self._op_stage("subop", t_sub0, trace_now(), span=sub_span,
                       fanout=len(tids), acked=a)
        acked = 1 + a
        for osd in failed:
            self.mc.report_failure(osd)
        if deposed and acked < pool.min_size:
            # deposed mid-op below quorum: the local apply is a FORK in a
            # dead interval — never acked, never answered as a dup
            # (_record_reqid marks the reqid "forked" so the resend
            # re-executes on the real primary).  At >= min_size the op
            # is durable in THIS interval despite the stray -116 (e.g. a
            # peer that just rebooted): ack it normally below.
            return MOSDOpReply(tid=msg.tid, retval=-116,
                               epoch=self.my_epoch(),
                               result={"deposed": True})
        # degraded-write policy: ack at min_size commits.  Shards that
        # missed the write are reported to the mon and filled by delta
        # recovery off the pg_log (reference: ECBackend requires min_size
        # acting shards; recovery completes the stripe)
        if acked >= pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"version": pg.version, "acked": acked})
        # structured under-ack refusal: the op IS applied+logged locally;
        # "applied" lets dup detection refuse re-execution on the resend
        return MOSDOpReply(tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                           result={"applied": pg.version, "acked": acked,
                                   "error": "below min_size commits"})

    # .. omap (replicated pools only, like the reference) ..................
    def _omap_op(self, pg, pool, acting, msg) -> MOSDOpReply:
        """librados omap surface (reference: rados_omap_get_vals /
        omap_set / omap_rm_keys / omap_clear, executed by
        PrimaryLogPG::do_osd_ops OMAP* cases).  Key-value pairs ride the
        object; mutations replicate and log exactly like xattr updates,
        and recovery pushes carry a full omap snapshot."""
        cid = self._cid(pg.pgid, 0)
        args = msg.data or {}
        if msg.op == "omap_get":
            try:
                self.store.stat(cid, msg.oid)
            except (NotFound, KeyError):
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(), result="not found")
            kv = self.store.omap_get(cid, msg.oid)
            want = args.get("keys")
            if want is not None:
                kv = {k: v for k, v in kv.items() if k in want}
            else:
                after = args.get("after") or ""
                maxn = int(args.get("max") or 0)
                keys = sorted(k for k in kv if k > after)
                if maxn:
                    keys = keys[:maxn]
                kv = {k: kv[k] for k in keys}
            return MOSDOpReply(
                tid=msg.tid, retval=0, epoch=self.my_epoch(),
                result={"kv": {k: pack_data(v) for k, v in kv.items()}},
            )
        # mutations
        omap_payload = None
        if msg.op == "omap_set":
            omap_payload = {"set": args.get("keys") or {}}
        elif msg.op == "omap_rm":
            omap_payload = {"rm": list(args.get("keys") or [])}
        elif msg.op == "omap_clear":
            omap_payload = {"clear": True}
        else:
            return MOSDOpReply(tid=msg.tid, retval=-22,
                               epoch=self.my_epoch(),
                               result=f"bad op {msg.op}")
        # omap content flushes to the base pool too: the clean clear must
        # be atomic with the mutation exactly like the data path
        autoclean = self._tier_autoclean(pool, msg.oid)
        with pg.lock:
            version = pg.version + 1
            entry = LogEntry(version, "modify", msg.oid,
                             reqid=getattr(msg, "reqid", None))
            tids: dict[int, int] = {}
            for shard, osd in enumerate(acting):
                if osd == self.id or osd < 0 or not self.osdmap.is_up(osd):
                    continue
                tid = self._next_tid()
                tids[tid] = shard
                try:
                    self._conn_to_osd(osd).send_message(MECSubOpWrite(
                        tid=tid, pgid=pg.pgid, oid=msg.oid, shard=0,
                        data=None, crc=None, version=version,
                        entry=entry.to_list(), epoch=self.my_epoch(),
                        omap=omap_payload,
                        rmattrs=["tier.clean"] if autoclean else None,
                    ))
                except (OSError, ConnectionError):
                    tids.pop(tid, None)
            t = Transaction()
            t.try_create_collection(cid)
            t.touch(cid, msg.oid)  # omap on a fresh oid creates it
            self._apply_omap(t, cid, msg.oid, omap_payload)
            # stamp the object version: _check_dup's applied-resend
            # verification counts shards holding ver >= v (replicated
            # pools never generation-filter reads, so this is safe)
            t.setattr(cid, msg.oid, "ver", str(version).encode())
            if autoclean:
                self._txn_clear_clean(t, cid, msg.oid)
            self._log_txn(t, cid, pg, entry)
            self.store.queue_transaction(t)
            a, deposed, _f = self._collect_subop_acks(tids)
            acked = 1 + a
        if deposed and acked < pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=-116,
                               epoch=self.my_epoch(),
                               result={"deposed": True})
        if acked < pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=-11,
                               epoch=self.my_epoch(),
                               result={"applied": pg.version, "acked": acked,
                                       "error": "below min_size commits"})
        return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                           result={"version": pg.version})

    # .. object classes (replicated pools only, like omap) .................
    def _exec_op(self, pg, pool, acting, msg) -> MOSDOpReply:
        """`rados exec` — run a registered class method at the primary
        under the PG lock and commit its staged mutations as one
        replicated, logged transaction (reference: PrimaryLogPG
        CEPH_OSD_OP_CALL -> ClassHandler; src/cls).  The lock-scoped
        execute-then-commit is what makes cls ops (bucket-index updates,
        create guards, counters) immune to concurrent-writer races."""
        from .classes import ClassRegistry, ClsHandle

        cid = self._cid(pg.pgid, 0)
        args = msg.data or {}
        fn = ClassRegistry.instance().get(
            args.get("cls", ""), args.get("method", "")
        )
        if fn is None:
            return MOSDOpReply(
                tid=msg.tid, retval=-95, epoch=self.my_epoch(),
                result=f"no class method "
                       f"{args.get('cls')}.{args.get('method')}",
            )
        # pool-snapshot clone-on-write, same as the plain mutation path
        # (lines above in _execute_routed_op): a method MAY stage a data
        # write (hctx.write_full), and the clone must capture the head
        # BEFORE pg.lock — the write path's order is _clone_mutex then
        # pg.lock, and inverting it here would risk deadlock.  We cannot
        # yet know whether the method will touch data, so clone whenever
        # a snap is live: a clone of an omap-only exec is merely the
        # head's (correct) at-snap state, never wrong.
        live_max = max(pool.snaps, default=0)
        snap_seq = max(live_max, int(getattr(msg, "snap_seq", 0) or 0))
        head_existed = True
        if snap_seq and msg.oid and CLONE_SEP not in msg.oid:
            try:
                head_existed = self._maybe_clone(pg, pool, msg.oid, snap_seq)
            except Exception as e:
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result=f"snap clone failed: {e}",
                )
        with pg.lock:
            def read_data():
                try:
                    return self.store.read(cid, msg.oid)
                except (NotFound, KeyError):
                    return None

            def read_omap():
                try:
                    return self.store.omap_get(cid, msg.oid)
                except (NotFound, KeyError):
                    return {}

            hctx = ClsHandle(msg.oid, read_data, read_omap)
            try:
                retval, out = fn(hctx, args.get("in") or {})
            except Exception as e:
                self.cct.dout("osd", 0,
                              f"{self.whoami} cls method raised: {e!r}")
                return MOSDOpReply(tid=msg.tid, retval=-22,
                                   epoch=self.my_epoch(),
                                   result=f"cls method failed: {e}")
            if retval < 0 or not hctx.dirty:
                # aborted or read-only: nothing to commit or replicate
                return MOSDOpReply(tid=msg.tid, retval=retval,
                                   epoch=self.my_epoch(),
                                   result={"cls_out": out})
            omap_payload = None
            if hctx.staged_set or hctx.staged_rm:
                omap_payload = {
                    "set": {k: pack_data(v)
                            for k, v in hctx.staged_set.items()},
                    "rm": sorted(hctx.staged_rm),
                }
            wire_data = crc = osize = None
            if hctx.staged_data is not None:
                wire_data = pack_data(hctx.staged_data)
                crc = crc32c(hctx.staged_data)
                osize = len(hctx.staged_data)
            version = pg.version + 1
            entry = LogEntry(version, "modify", msg.oid,
                             reqid=getattr(msg, "reqid", None))
            autoclean = self._tier_autoclean(pool, msg.oid)
            tids: dict[int, int] = {}
            for shard, osd in enumerate(acting):
                if osd == self.id or osd < 0 or not self.osdmap.is_up(osd):
                    continue
                tid = self._next_tid()
                tids[tid] = shard
                try:
                    self._conn_to_osd(osd).send_message(MECSubOpWrite(
                        tid=tid, pgid=pg.pgid, oid=msg.oid, shard=0,
                        data=wire_data, crc=crc, osize=osize,
                        version=version, entry=entry.to_list(),
                        epoch=self.my_epoch(), omap=omap_payload,
                        rmattrs=["tier.clean"] if autoclean else None,
                    ))
                except (OSError, ConnectionError):
                    tids.pop(tid, None)
            t = Transaction()
            t.try_create_collection(cid)
            t.touch(cid, msg.oid)
            if hctx.staged_data is not None:
                t.write(cid, msg.oid, 0, hctx.staged_data)
                t.truncate(cid, msg.oid, len(hctx.staged_data))
                t.setattr(cid, msg.oid, "hinfo",
                          str(crc32c(hctx.staged_data)).encode())
                t.setattr(cid, msg.oid, "size",
                          str(len(hctx.staged_data)).encode())
            if omap_payload is not None:
                self._apply_omap(t, cid, msg.oid, omap_payload)
            t.setattr(cid, msg.oid, "ver", str(version).encode())
            if autoclean:
                self._txn_clear_clean(t, cid, msg.oid)
            self._log_txn(t, cid, pg, entry)
            self.store.queue_transaction(t)
            a, deposed, _f = self._collect_subop_acks(tids)
            acked = 1 + a
        if deposed and acked < pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=-116,
                               epoch=self.my_epoch(),
                               result={"deposed": True})
        if acked < pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=-11,
                               epoch=self.my_epoch(),
                               result={"applied": pg.version, "acked": acked,
                                       "error": "below min_size commits"})
        if snap_seq and not head_existed:
            # exec CREATED the object post-snap: mark it born so older
            # snap views keep it invisible (same contract as the plain
            # write path's _mark_born)
            try:
                self._mark_born(pg, pool, msg.oid, snap_seq)
            except Exception as e:
                return MOSDOpReply(
                    tid=msg.tid, retval=-5, epoch=self.my_epoch(),
                    result=f"snapborn mark failed: {e}",
                )
        return MOSDOpReply(tid=msg.tid, retval=retval,
                           epoch=self.my_epoch(), result={"cls_out": out})

    def _apply_omap(self, t: Transaction, cid: str, oid: str,
                    payload: dict) -> None:
        if payload.get("snapshot") is not None:
            # recovery push: the dict IS the whole omap
            t.omap_clear(cid, oid)
            t.omap_setkeys(cid, oid, {
                k: unpack_data(v) for k, v in payload["snapshot"].items()
            })
            return
        if payload.get("clear"):
            t.omap_clear(cid, oid)
        if payload.get("set"):
            t.omap_setkeys(cid, oid, {
                k: unpack_data(v) for k, v in payload["set"].items()
            })
        if payload.get("rm"):
            t.omap_rmkeys(cid, oid, payload["rm"])

    # .. watch / notify ....................................................
    def _watch_op(self, pg, pool, msg) -> MOSDOpReply:
        """Object watch/notify (reference: PrimaryLogPG watch/notify +
        MWatchNotify).  Watch state is primary-local and in-memory; the
        client's Objecter re-registers lingering watches after a map
        change (reference: linger ops re-sent by Objecter), which covers
        primary failover."""
        args = msg.data or {}
        key = (msg.pool, msg.oid)
        if msg.op == "watch":
            cookie = int(args.get("cookie") or 0)
            with self._watch_lock:
                self.watchers.setdefault(key, {})[cookie] = (
                    getattr(msg, "src", None))
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"cookie": cookie})
        if msg.op == "unwatch":
            cookie = int(args.get("cookie") or 0)
            with self._watch_lock:
                ws = self.watchers.get(key, {})
                ws.pop(cookie, None)
                if not ws:
                    self.watchers.pop(key, None)
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={})
        # notify: fan out to every watcher, collect acks with a timeout
        notify_id = self._next_tid()
        payload = args.get("payload")
        timeout = float(args.get("timeout") or 5.0)
        with self._watch_lock:
            targets = dict(self.watchers.get(key, {}))
        pending = {}
        dead = []
        unreachable = []
        for cookie, src in targets.items():
            conn = self._client_conns.get(src)
            if conn is None:
                # conn LRU-evicted or never seen: the watcher may be
                # alive and idle — report it missed, do NOT reap (only a
                # CONFIRMED-dead connection expires a watch)
                unreachable.append(cookie)
                continue
            try:
                conn.send_message(MWatchNotify(
                    notify_id=notify_id, pool=msg.pool, oid=msg.oid,
                    cookie=cookie, data=payload,
                ))
                pending[cookie] = src
            except (OSError, ConnectionError):
                dead.append(cookie)
        if dead:
            # a watcher whose connection is gone is expired (reference:
            # watch timeout reaps dead watchers); its client re-lingers
            # on the next map push if it is actually alive
            with self._watch_lock:
                ws = self.watchers.get(key, {})
                for cookie in dead:
                    ws.pop(cookie, None)
                if not ws:
                    self.watchers.pop(key, None)
        acked, missed = [], list(unreachable)
        deadline = time.monotonic() + timeout
        for cookie in pending:
            remain = max(0.0, deadline - time.monotonic())
            if self._wait_notify_ack(notify_id, cookie, remain):
                acked.append(cookie)
            else:
                missed.append(cookie)
        return MOSDOpReply(
            tid=msg.tid, retval=0, epoch=self.my_epoch(),
            result={"notify_id": notify_id, "acked": acked,
                    "missed": missed},
        )

    def _wait_notify_ack(self, notify_id: int, cookie: int,
                         timeout: float) -> bool:
        with self._watch_cond:
            return self._watch_cond.wait_for(
                lambda: (notify_id, cookie) in self._notify_acks,
                timeout=timeout,
            )

