"""Client-op execution on the primary (reference: src/osd/PrimaryLogPG.cc do_op/do_osd_ops) plus pool-snapshot clone-on-write (make_writeable).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations


import threading
import time


from ..common.tracer import TRACER, TraceCtx, set_op_trace, trace_now
from ..store.object_store import NotFound
from .messages import (
    MECSubOpRead,
    MOSDOp,
    MOSDOpReply,
    pack_data,
    unpack_data,
)
from ..osd.osdmap import PG_POOL_ERASURE, object_ps
from .pg import CLONE_SEP, MUTATING_OPS


#: replies the Objecter answers by resending the op under the same reqid
#: (EAGAIN: not active or behind the client's map; ESTALE: wrong
#: primary): the op did not run, and counting it would count its bytes
#: again when the resend lands
RESENT_RETVALS = (-11, -116)


class PrimaryOpsMixin:
    # -- client ops (primary) ---------------------------------------------
    def _handle_client_op(self, conn, msg: MOSDOp) -> None:
        t0 = time.perf_counter()
        self.logger.inc("op")
        wr_bytes = len(msg.data or "") * 3 // 4 if msg.op == "write_full" else 0
        tracked = self.op_tracker.create(
            f"osd_op({msg.op} {msg.pool}.{msg.oid} tid={msg.tid})"
        )
        # cephmeter: (client entity, pool) stamp — msg.src is the
        # messenger-framed entity name the Objecter sends under.  These
        # labels ARE the future mClock tags; the accounting table and
        # the write batcher (through the op-trace state) attribute
        # per-stage latency to them (docs/observability.md)
        client = getattr(msg, "src", None) or "client._unknown_"
        tracked.trace_id = getattr(msg, "trace_id", None)
        # cephtrace: adopt the client's context (one attribute check
        # when tracing is off).  The osd_op span parents every stage
        # span below; the thread-local op-trace state is how the write
        # batcher / encode / sub-op layers find it without threading a
        # ctx through every signature.
        osd_span = None
        if TRACER.enabled and getattr(msg, "trace_id", None) is not None:
            osd_span = TRACER.begin(
                TraceCtx(msg.trace_id, msg.parent_span), "osd_op",
                entity=self.whoami, op=msg.op, oid=msg.oid, tid=msg.tid,
            )
            rx = getattr(msg, "_rx_ts", None)
            if osd_span is not None and rx is not None:
                # mClock dispatch-queue wait (arrival -> execution)
                TRACER.record(osd_span.ctx(), "dispatch_queue",
                              entity=self.whoami, t0=rx, t1=osd_span.t0)
        set_op_trace({
            "ctx": osd_span.ctx() if osd_span is not None else None,
            "tracked": tracked,
            "acct": ((self.io_acct, client, msg.pool)
                     if self.io_acct is not None else None),
        })
        reply = None
        try:
            tracked.mark_event("started")
            reply = self._execute_client_op(msg)
        except Exception as e:  # never leave the client hanging
            tracked.mark_event(f"failed: {e!r}")
            self.cct.dout("osd", 0, f"{self.whoami} op failed: {e!r}")
            reply = MOSDOpReply(
                tid=msg.tid, retval=-5, epoch=self.my_epoch(),
                result=f"internal error: {e}",
            )
        finally:
            tracked.finish()
            set_op_trace(None)
            TRACER.end(osd_span,
                       retval=reply.retval if reply is not None else None)
            if TRACER.enabled and tracked.trace_id is not None:
                self._maybe_tail_promote(tracked)
        ran = reply.retval not in RESENT_RETVALS
        if ran and msg.op == "write_full":
            self.logger.inc("op_w")
            self.logger.inc("op_w_bytes", wr_bytes)
        elif ran and msg.op == "read":
            self.logger.inc("op_r")
        if msg.op == "read" and reply.retval == 0 and reply.data:
            self.logger.inc("op_r_bytes", len(reply.data) * 3 // 4)
        if self.io_acct is not None and ran:
            nbytes = wr_bytes
            if msg.op == "read" and reply.retval == 0 and reply.data:
                nbytes = len(reply.data) * 3 // 4
            self.io_acct.record_op(client, msg.pool, msg.op,
                                   nbytes=nbytes, e2e=tracked.duration())
        self.logger.tinc("op_latency", time.perf_counter() - t0)
        try:
            conn.send_message(reply)
        except (OSError, ConnectionError):
            pass

    def _maybe_tail_promote(self, tracked) -> None:
        """cephmeter tail sampling, primary side: an op that crossed
        osd_op_complaint_time or trace_tail_latency_ms promotes its
        provisionally buffered trace into the real buffer — even when
        the head coin flip said no (trace_sampling_rate=0).  Runs after
        the osd_op span ended, so the whole OSD-side subtree (and the
        replicas' commit spans, already ended before the acks were
        collected) moves together."""
        dur = tracked.duration()
        complaint = self.op_tracker.complaint_time
        tail_ms = float(self.cct.conf.get("trace_tail_latency_ms"))
        if complaint > 0 and dur > complaint:
            TRACER.promote(tracked.trace_id, reason="osd_complaint")
        elif tail_ms > 0 and dur * 1e3 >= tail_ms:
            TRACER.promote(tracked.trace_id, reason="osd_tail")

    def _execute_client_op(self, msg: MOSDOp) -> MOSDOpReply:
        # the client targeted with a NEWER map than ours: wait for it
        # before deciding anything (reference: OSD::require_same_or_newer_map
        # waiting_for_map) — answering from the stale map would yield
        # false 'no such pool' / wrong-primary verdicts
        if msg.epoch and msg.epoch > self.my_epoch():
            deadline = time.monotonic() + 10.0
            while (
                msg.epoch > self.my_epoch()
                and time.monotonic() < deadline
                and not self._stop.is_set()
            ):
                time.sleep(0.05)
            if msg.epoch > self.my_epoch():
                # still behind: NACK retryably — answering from a map the
                # client provably outdates would yield FINAL wrong results
                # ('no such pool', wrong primary)
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result="waiting for newer osdmap",
                )
        m = self.osdmap
        pool = m.pools.get(msg.pool) if m else None
        if m is None or pool is None:
            return MOSDOpReply(tid=msg.tid, retval=-2, epoch=self.my_epoch(),
                               result="no such pool")
        if (
            msg.op in ("list", "scrub", "scrub-noprepair")
            and msg.oid
            and msg.oid.startswith(":pg:")
        ):
            ps = int(msg.oid[4:])  # pg-targeted op (tools/librados)
        elif getattr(msg, "ps", None) is not None:
            # explicit placement seed: the split migrator addressing an
            # object still housed in its pre-split PG
            ps = int(msg.ps)
        else:
            ps = object_ps(msg.oid, pool.pg_num) if msg.oid else 0
        if msg.op in ("scrub", "scrub-noprepair"):
            try:
                result = self.scrub_pg(msg.pool, ps,
                                       repair=msg.op == "scrub")
                return MOSDOpReply(tid=msg.tid, retval=0,
                                   epoch=self.my_epoch(), result=result)
            except RuntimeError:
                pass  # not primary: fall through to the -116 NACK below
        acting, primary = self._acting(msg.pool, ps)
        if primary != self.id:
            # client raced a map change (Objecter resend rule)
            return MOSDOpReply(
                tid=msg.tid, retval=-116, epoch=self.my_epoch(),
                result={"primary": primary},
            )
        pg = self._pg(msg.pool, ps)
        if pg.activated_interval != pg.interval_start:
            # not yet peered for the current interval: refuse retryably
            # and peer NOW (reference: ops wait on PG activation)
            self._recovery_wakeup.set()
            return MOSDOpReply(
                tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                result="peering: pg not active in this interval",
            )
        # dup detection + in-flight serialization (reference: pg_log dup
        # entries + PrimaryLogPG::check_in_progress_op): a resend of a
        # completed mutation is answered without re-executing — from the
        # reply cache, or (surviving primary changes) from the reqid the
        # REPLICATED log entry carries; a resend racing the still-running
        # original waits for it instead of double-executing
        reqid = getattr(msg, "reqid", None)
        if reqid is not None and msg.op in MUTATING_OPS:
            rep = self._check_dup(pg, pool, acting, msg, reqid)
            if rep is not None:
                return rep
            while True:
                guard = threading.Event()
                prior = pg.inflight.setdefault(reqid, guard)
                if prior is guard:
                    # we own the slot — but the original may have
                    # COMPLETED between our _check_dup miss and now
                    # (check-then-act): re-check before executing
                    rep = self._check_dup(pg, pool, acting, msg, reqid)
                    if rep is not None:
                        pg.inflight.pop(reqid, None)
                        guard.set()
                        return rep
                    break
                if not prior.wait(60.0):
                    # original STILL running (e.g. a long degraded
                    # splice): executing now would double-apply — refuse
                    # retryably and let the next resend re-check
                    return MOSDOpReply(
                        tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                        result="op with same reqid still in flight",
                    )
                rep = self._check_dup(pg, pool, acting, msg, reqid)
                if rep is not None:
                    return rep
                # the original died before logging anything — loop back
                # to CONTEND for the slot (setdefault): two waiters must
                # not both install themselves and double-execute
            try:
                return self._execute_routed_op(pg, pool, acting, ps, msg)
            finally:
                pg.inflight.pop(reqid, None)
                guard.set()
        return self._execute_routed_op(pg, pool, acting, ps, msg)

    def _check_dup(self, pg, pool, acting, msg, reqid) -> MOSDOpReply | None:
        """Reply for an already-seen reqid, or None to execute."""
        hit = pg.reqid_cache.get(reqid)
        if hit is not None and hit[0] == "forked":
            # executed here in a DEAD interval: the fork is invisible to
            # the real history; re-execute (a still-stale primary gets
            # deposed again until its map catches up)
            return None
        if hit is None:
            v = pg.log.find_reqid(reqid)
            if v is not None:
                hit = ("applied", v)
        if hit is None:
            return None
        if hit[0] == "done":
            return MOSDOpReply(tid=msg.tid, retval=hit[1],
                               epoch=self.my_epoch(), result=hit[2])
        # ("applied", v): the op mutated state exactly once but was
        # under-acked (< min_size commits) at the time.  Never re-execute.
        # Success is reported only when the write has ACTUALLY reached
        # min_size shards — counted from the per-object version stamps,
        # not mere reachability (reachable-but-unrecovered shards don't
        # hold the data yet).  Deletes are idempotent at the log level:
        # applied = done.
        if msg.op == "delete":
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"version": pg.version, "dup": True})
        holding = 0
        is_ec = pool.type == PG_POOL_ERASURE
        for shard, osd in enumerate(acting):
            if osd < 0:
                continue
            # replicated pools keep every replica in the shard-0
            # collection; only EC pools have per-shard collections
            store_shard = shard if is_ec else 0
            if osd == self.id:
                v = self._stored_ver(self._cid(pg.pgid, store_shard),
                                     msg.oid)
                if v is not None and v >= hit[1]:
                    holding += 1
                continue
            if not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(MECSubOpRead(
                    tid=tid, pgid=pg.pgid, oid=msg.oid, shard=store_shard,
                    offsets=[], epoch=self.my_epoch(),
                ))
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid, timeout=5.0)
            if rep is None or rep.retval != 0:
                continue
            v = getattr(rep, "ver", None)
            if v is not None and v >= hit[1]:
                holding += 1
        if holding >= pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"version": pg.version, "dup": True})
        # the op is durably logged but under-replicated: recovery is the
        # only path to an ack, so kick it rather than wait for the tick
        self._recovery_wakeup.set()
        return MOSDOpReply(
            tid=msg.tid, retval=-11, epoch=self.my_epoch(),
            result=f"applied at v{hit[1]}; {holding} shards hold it "
                   f"< min_size {pool.min_size}",
        )

    def _execute_routed_op(self, pg, pool, acting, ps, msg) -> MOSDOpReply:
        quota_pools = ["full_quota" in getattr(pool, "flags", ())]
        if pool.tier_of >= 0 and self.osdmap is not None:
            # a CACHE pool fronts its base: client writes redirected
            # here must honor the BASE pool's quota or the overlay
            # becomes a quota bypass (review r5)
            base = self.osdmap.pools.get(pool.tier_of)
            quota_pools.append(
                base is not None
                and "full_quota" in getattr(base, "flags", ())
            )
        if (
            any(quota_pools)
            and msg.op in MUTATING_OPS
            and msg.op != "delete"  # deletes free space, always allowed
            # internal tier traffic (flush/promote staging) moves bytes
            # BETWEEN the tiers, bounded by the cache size — refusing it
            # would wedge dirty objects in the cache forever
            and not str(getattr(msg, "reqid", "") or "").startswith("tier.")
        ):
            # reference: PrimaryLogPG refuses writes on FLAG_FULL_QUOTA
            # pools with -EDQUOT; the mgr's quota loop set the flag
            return MOSDOpReply(
                tid=msg.tid, retval=-122, epoch=self.my_epoch(),
                result=f"pool {pool.name!r} quota exceeded (EDQUOT)",
            )
        if msg.op == "write" and int(msg.off or 0) < 0:
            # reference: negative offsets are -EINVAL; Python slicing
            # would otherwise silently splice into the object's tail
            return MOSDOpReply(tid=msg.tid, retval=-22,
                               epoch=self.my_epoch(),
                               result="negative write offset")
        # cache-tier front-end: a PG in a cache pool stages/proxies/
        # whiteouts before normal execution (reference: PrimaryLogPG::
        # maybe_handle_cache_detail runs before do_op proper)
        if pool.tier_of >= 0 and pool.cache_mode != "none":
            rep = self._cache_tier_op(pg, pool, acting, ps, msg)
            if rep is not None:
                return self._record_reqid(pg, msg, rep)
        # pool snapshots (reference: make_writeable's clone-on-write +
        # SnapSet resolution in PrimaryLogPG)
        # clone against the newest LIVE snap (snap_seq never resets, and
        # cloning for snaps that no longer exist would leak un-trimmable
        # copies on every first write); the client's snap context covers
        # the window where this map lags a fresh mksnap
        live_max = max(pool.snaps, default=0)
        snap_seq = max(live_max, int(getattr(msg, "snap_seq", 0) or 0))
        if (
            msg.op in ("write_full", "write", "append", "delete")
            and snap_seq
            and msg.oid
            and CLONE_SEP not in msg.oid
            and getattr(msg, "ps", None) is None
            # explicit-ps ops are internal machinery (split migration,
            # trim), not client mutations: the split's old-PG delete must
            # not mint a stranded clone — the head's bytes live on,
            # unchanged, in the post-split PG
        ):
            try:
                head_existed = self._maybe_clone(pg, pool, msg.oid, snap_seq)
            except Exception as e:
                # clone failures are overwhelmingly transient races (a
                # map change mid-op re-targeting the internal clone
                # write, a peer mid-recovery): refuse RETRYABLY so the
                # client resends to the current primary — a fatal -EIO
                # here would fail a write that the next attempt performs
                # cleanly
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result=f"snap clone failed: {e}",
                )
            if msg.op in ("write_full", "write", "append") and not head_existed:
                rep = (
                    self._ec_op(pg, pool, acting, msg)
                    if pool.type == PG_POOL_ERASURE
                    else self._replicated_op(pg, pool, acting, msg)
                )
                if rep.retval == 0:
                    try:
                        self._mark_born(pg, pool, msg.oid, snap_seq)
                    except Exception as e:
                        # same contract as _set_born: a lost born marker
                        # would surface this object in snap views older
                        # than its creation, so fail the write instead
                        return MOSDOpReply(
                            tid=msg.tid, retval=-5, epoch=self.my_epoch(),
                            result=f"snapborn mark failed: {e}",
                        )
                return self._record_reqid(pg, msg, rep)
        if (
            msg.op == "read"
            and getattr(msg, "snapid", None)
            and CLONE_SEP not in msg.oid
        ):
            clone_oid = self._resolve_snap_read(
                pg, pool, acting, msg.oid, int(msg.snapid)
            )
            if clone_oid is None:
                # object was created after the snapshot
                return MOSDOpReply(
                    tid=msg.tid, retval=-2, epoch=self.my_epoch(),
                    result="did not exist at snap",
                )
            if clone_oid != msg.oid:
                msg = MOSDOp(
                    tid=msg.tid, pool=msg.pool, oid=clone_oid, op="read",
                    epoch=msg.epoch, off=msg.off, length=msg.length,
                    ps=ps,
                )
        if pool.type == PG_POOL_ERASURE:
            rep = self._ec_op(pg, pool, acting, msg)
        else:
            rep = self._replicated_op(pg, pool, acting, msg)
        return self._record_reqid(pg, msg, rep)

    def _collect_subop_acks(self, tids: dict, acting=None):
        """(acked_remote, deposed, failed_osds) over a tid->shard map.
        `deposed` = some peer answered -116: it is in a NEWER interval
        than the epoch we stamped — we may have been deposed mid-op."""
        acked = 0
        deposed = False
        failed: list[int] = []
        for tid, shard in tids.items():
            rep = self._wait_reply(tid)
            if rep is not None and rep.retval == 0:
                acked += 1
            elif rep is not None and rep.retval == -116:
                deposed = True
            elif acting is not None:
                failed.append(acting[shard])
        return acked, deposed, failed

    def _record_reqid(self, pg, msg, rep: MOSDOpReply) -> MOSDOpReply:
        """Remember a completed mutation's outcome for dup detection.
        Successes cache the full reply; an UNDER-ACKED mutation (applied
        and logged, but < min_size commits, reported -11) caches the
        applied-at version so the resend re-evaluates availability
        instead of re-executing — re-running an append/RMW would
        double-apply.  Plain refusals (gate -11, -ESTALE) that mutated
        nothing cache nothing and re-execute freely."""
        reqid = getattr(msg, "reqid", None)
        if reqid is None or msg.op not in MUTATING_OPS:
            return rep
        if rep.retval == 0:
            pg.reqid_cache[reqid] = ("done", rep.retval, rep.result)
        elif (
            rep.retval == -116
            and isinstance(rep.result, dict)
            and rep.result.get("deposed")
        ):
            # the op executed on a DEPOSED primary: its local log entry
            # is a fork in a dead interval — the marker stops this OSD's
            # own log from answering the resend as an "applied" dup
            pg.reqid_cache[reqid] = ("forked",)
        elif (
            rep.retval == -11
            and isinstance(rep.result, dict)
            and "applied" in rep.result
        ):
            pg.reqid_cache[reqid] = ("applied", rep.result["applied"])
            self._recovery_wakeup.set()  # under-acked: converge now
        else:
            return rep
        while len(pg.reqid_cache) > 1024:
            pg.reqid_cache.popitem(last=False)
        return rep

    # -- pool snapshots ----------------------------------------------------
    def _clone_oid(self, oid: str, snapid: int) -> str:
        return f"{oid}{CLONE_SEP}{snapid:08d}"

    def _maybe_clone(self, pg, pool, oid: str, snap_seq: int) -> None:
        """Clone-on-first-write-after-snap: preserve the head's bytes as
        clone `snap_seq` before an overwrite/delete mutates it.  The clone
        is a full normal object in the SAME PG (explicit ps), so
        replication/EC encoding, recovery, and scrub all cover it.

        The stat->read->write sequence is serialized under _clone_mutex:
        two concurrent writers racing it could otherwise both miss the
        stat and the later one would capture POST-snap bytes as the
        clone, corrupting the snapshot view."""
        with self._clone_mutex:
            return self._maybe_clone_locked(pg, pool, oid, snap_seq)

    def _maybe_clone_locked(self, pg, pool, oid: str, snap_seq: int) -> bool:
        """Returns True when the head EXISTED (clone made or already
        present); False = brand-new object this write creates."""
        clone = self._clone_oid(oid, snap_seq)
        e = self.my_epoch()
        st = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pool.pool_id, oid=clone, op="stat",
            epoch=e, ps=pg.ps,
        ))
        if st.retval == 0:
            # this snap generation already preserved; a retried clone
            # whose marker write was interrupted gets repaired here (the
            # marker is what keeps born-after objects out of older views)
            if self._born_of(pg, pool, clone) == 0:
                born = self._born_of(pg, pool, oid)
                if born:
                    self._set_born(pg, pool, clone, born)
            return True
        r = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pool.pool_id, oid=oid, op="read",
            epoch=e, ps=pg.ps, off=0, length=0,
        ))
        if r.retval != 0:
            return False  # no head: nothing to preserve
        w = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pool.pool_id, oid=clone,
            op="write_full", data=r.data, epoch=e, ps=pg.ps,
        ))
        if w.retval != 0:
            raise RuntimeError(f"clone write: {w.result}")
        born = self._born_of(pg, pool, oid)
        if born:
            self._set_born(pg, pool, clone, born)
        return True

    def _set_born(self, pg, pool, oid: str, born: int) -> None:
        r = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pool.pool_id, oid=oid,
            op="setxattr", epoch=self.my_epoch(), ps=pg.ps,
            data={"_snapborn": pack_data(str(born).encode())},
        ))
        if r.retval != 0:
            # fail the client write rather than leave a clone that would
            # surface a born-after object in older snap views
            raise RuntimeError(f"clone born-marker write: {r.result}")

    def _born_of(self, pg, pool, oid: str) -> int:
        """Snap generation an object (head or clone) was created in; 0 =
        pre-snapshot or unmarked."""
        xr = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pool.pool_id, oid=oid,
            op="getxattrs", epoch=self.my_epoch(), ps=pg.ps,
        ))
        if xr.retval == 0 and isinstance(xr.result, dict):
            born = xr.result.get("_snapborn")
            if born is not None:
                try:
                    return int(unpack_data(born).decode())
                except (ValueError, AttributeError):
                    pass
        return 0

    def _mark_born(self, pg, pool, oid: str, snap_seq: int) -> None:
        """Stamp a newly created object with the snap generation it was
        born in, so snapshot reads older than its creation return ENOENT
        instead of the head (reference: SnapSet knows object existence
        per snap).  Rides the replicated user-xattr path under a
        reserved '_'-name the client surface filters out.  Raises on
        persistent failure (after one retry) — the caller fails the
        client write, matching _set_born's contract."""
        r = None
        for _ in range(2):
            r = self._execute_client_op(MOSDOp(
                tid=self._next_tid(), pool=pool.pool_id, oid=oid,
                op="setxattr", epoch=self.my_epoch(), ps=pg.ps,
                data={"_snapborn": pack_data(str(snap_seq).encode())},
            ))
            if r.retval == 0:
                return
        raise RuntimeError(f"snapborn marker write: {r.result}")

    def _primary_cid(self, pg, pool, acting) -> str:
        shard = acting.index(self.id) if pool.type == PG_POOL_ERASURE else 0
        return self._cid(pg.pgid, shard)

    def _resolve_snap_read(
        self, pg, pool, acting, oid: str, snapid: int
    ) -> str:
        """Oldest clone at-or-after `snapid` serves the snapshot view; no
        such clone means the head hasn't changed since (or never existed).
        reference: SnapSet::get_clone_bytes / find_object lookup."""
        prefix = oid + CLONE_SEP
        try:
            names = self.store.list_objects(
                self._primary_cid(pg, pool, acting)
            )
        except (NotFound, KeyError):
            return oid
        ids = sorted(
            int(n[len(prefix):]) for n in names if n.startswith(prefix)
        )
        for c in ids:
            if c >= snapid:
                clone = self._clone_oid(oid, c)
                # the clone inherits its head's born marker: a clone made
                # AFTER a post-snap creation must not make the object
                # appear in older snap views
                if self._born_of(pg, pool, clone) >= snapid:
                    return None
                return clone
        # no clone: the head serves the snap view — unless the object was
        # born after the snapshot (its _snapborn generation >= snapid)
        if self._born_of(pg, pool, oid) >= snapid:
            return None
        return oid

    def _snaptrim_pass(self) -> None:
        """Remove clones no live snap needs (reference: the snap-trim
        queue PrimaryLogPG works through after a snap is deleted, fed by
        SnapMapper).  A clone c of a head covers snaps in (prev_clone, c];
        with none of those alive it is garbage."""
        m = self.osdmap
        if m is None:
            return
        for pgid, pg in list(self.pgs.items()):
            if self._stop.is_set():
                return
            pool = m.pools.get(pg.pool_id)
            if pool is None:
                continue
            live_key = tuple(sorted(pool.snaps))
            if pg.snap_trimmed == live_key:
                continue
            acting, primary = self._acting(pg.pool_id, pg.ps)
            if primary != self.id or self.id not in acting:
                continue
            try:
                self._snaptrim_pg(pg, pool, acting, live_key)
                pg.snap_trimmed = live_key
            except Exception as e:
                self.cct.dout(
                    "osd", 1, f"{self.whoami} snaptrim {pgid}: {e!r}"
                )

    def _snaptrim_pg(self, pg, pool, acting, live_key) -> None:
        try:
            names = self.store.list_objects(
                self._primary_cid(pg, pool, acting)
            )
        except (NotFound, KeyError):
            return
        by_head: dict[str, list[int]] = {}
        for n in names:
            if CLONE_SEP in n:
                head, _, suffix = n.partition(CLONE_SEP)
                by_head.setdefault(head, []).append(int(suffix))
        live = sorted(live_key)
        snap_seq = max([pool.snap_seq, *live_key]) if live_key else pool.snap_seq
        for head, ids in by_head.items():
            ids.sort()
            prev = 0
            for c in ids:
                if c > snap_seq:
                    # a generation this map hasn't seen yet (clone minted
                    # from a newer client's snap context right after a
                    # mksnap): deleting it would destroy the new snapshot
                    prev = c
                    continue
                needed = any(prev < s <= c for s in live)
                prev = c
                if needed:
                    continue
                d = self._execute_client_op(MOSDOp(
                    tid=self._next_tid(), pool=pool.pool_id,
                    oid=self._clone_oid(head, c), op="delete",
                    epoch=self.my_epoch(), ps=pg.ps,
                ))
                if d.retval != 0:
                    raise RuntimeError(f"trim {head}@{c}: {d.result}")

