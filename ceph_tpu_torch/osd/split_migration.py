"""PG split migration on pg_num increase (reference: PG::split_into + the upmap-era split machinery).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations




from ..store.object_store import NotFound
from .messages import (
    MOSDOp,
)
from ..osd.osdmap import PG_POOL_ERASURE, object_ps
from .messages import MOSDPingMsg
from .pg import CLONE_SEP


class SplitMigrationMixin:
    # -- PG split migration (pg_num increase) ------------------------------
    def _split_pass_work(self) -> None:
        try:
            self._split_pass()
            self._snaptrim_pass()
            self._tier_agent_pass()
        finally:
            with self._lock:
                self._split_inflight = False

    def _split_pass(self) -> None:
        """Migrate objects stranded in pre-split PGs (reference: PG split —
        OSD::split_pgs + backfill; here the old-PG primary rewrites each
        misplaced object through the normal client-op path to its
        post-split PG, then deletes the old copy).

        Eventually consistent: the pass re-runs every tick until each
        primary PG has been scanned clean under the current pg_num, so an
        OSD that was down during the split finishes the job when it
        returns.  Window semantics: until an object is migrated, clients
        on the new map read -ENOENT from the post-split PG (the reference
        covers this window with pg history + peering; SURVEY's data plane
        accepts the brief window)."""
        m = self.osdmap
        if m is None:
            return
        for pgid, pg in list(self.pgs.items()):
            if self._stop.is_set():
                return
            pool = m.pools.get(pg.pool_id)
            if pool is None or pg.split_scanned >= pool.pg_num:
                continue
            _acting, primary = self._acting(pg.pool_id, pg.ps)
            if primary != self.id:
                continue  # re-checked next pass (primary may change)
            try:
                self._split_migrate_pg(pg, pool)
                pg.split_scanned = pool.pg_num
            except Exception as e:
                self.cct.dout(
                    "osd", 1, f"{self.whoami} split pass {pgid}: {e!r}"
                )

    def _split_migrate_pg(self, pg, pool) -> None:
        # raw store listing: snapshot clones are hidden from the client
        # `list` op but must migrate with their head
        acting, _p = self._acting(pg.pool_id, pg.ps)
        if self.id not in acting:
            return
        try:
            names = self.store.list_objects(
                self._primary_cid(pg, pool, acting)
            )
        except (NotFound, KeyError):
            return
        for oid in sorted(names):
            if oid.startswith("_"):
                continue
            head = oid.split(CLONE_SEP, 1)[0]
            new_ps = object_ps(head, pool.pg_num)
            if new_ps != pg.ps:
                self._migrate_object(pg, pool, oid, new_ps)

    def _forward_op(self, target: int, msg: MOSDOp):
        """Execute an op locally when this OSD is the target primary, else
        ship it and wait (the OSD acting as its own Objecter)."""
        if target == self.id:
            return self._execute_client_op(msg)
        conn = self._conn_to_osd(target)
        conn.send_message(msg)
        return self._wait_reply(msg.tid, timeout=15.0)

    def _migrate_object(self, pg, pool, oid: str, new_ps: int) -> None:
        """write-to-new-PG before delete-from-old: a crash mid-migration
        leaves a duplicate (invisible: lookups hash to the new PG), never
        a loss.

        Lost-update guard: a client on the new map may have ALREADY
        written the object into its post-split PG; the stale pre-split
        copy must not clobber it, so the destination is stat'd first and
        a hit just drops the old copy.  (A write landing between the stat
        and our write is the residual window; the reference closes it
        with peering's authoritative log — out of scope here and noted.)
        """
        e = self.my_epoch()
        _a, new_primary = self._acting(pg.pool_id, new_ps)
        # every dest op carries the explicit post-split ps: snapshot-clone
        # names would hash elsewhere (placement follows their HEAD object)
        st = self._forward_op(new_primary, MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid, op="stat",
            epoch=e, ps=new_ps,
        ))
        if st is not None and st.retval == 0:
            # newer post-split copy exists: just retire the stale one
            d = self._execute_client_op(MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="delete", epoch=e, ps=pg.ps,
            ))
            if d.retval != 0:
                raise RuntimeError(f"split retire {oid}: {d.result}")
            return
        r = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid, op="read",
            epoch=e, ps=pg.ps, off=0, length=0,
        ))
        if r.retval != 0:
            raise RuntimeError(f"split read {oid}: {r.result}")
        xr = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid,
            op="getxattrs", epoch=e, ps=pg.ps,
        ))
        xattrs = xr.result if xr.retval == 0 else None
        w = self._forward_op(new_primary, MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid,
            op="write_full", data=r.data, epoch=e, ps=new_ps,
        ))
        if w is None or w.retval != 0:
            raise RuntimeError(
                f"split write {oid}: {w.result if w else 'timeout'}"
            )
        if xattrs:
            xw = self._forward_op(new_primary, MOSDOp(
                tid=self._next_tid(), pool=pg.pool_id, oid=oid,
                op="setxattr", data=xattrs, epoch=e, ps=new_ps,
            ))
            if xw is None or xw.retval != 0:
                raise RuntimeError(
                    f"split xattrs {oid}: {xw.result if xw else 'timeout'}"
                )
        d = self._execute_client_op(MOSDOp(
            tid=self._next_tid(), pool=pg.pool_id, oid=oid, op="delete",
            epoch=e, ps=pg.ps,
        ))
        if d.retval != 0:
            raise RuntimeError(f"split delete {oid}: {d.result}")
        self.cct.dout(
            "osd", 10,
            f"{self.whoami} split: migrated {oid} "
            f"{pg.pool_id}.{pg.ps} -> {pg.pool_id}.{new_ps}",
        )

    def _maybe_schedule_scrub(self, now: float) -> None:
        """Periodic deep scrub of primary PGs (reference: OSD::sched_scrub;
        osd_deep_scrub_interval 0 disables — tests drive scrub_pg
        directly)."""
        interval = self.cct.conf.get("osd_deep_scrub_interval")
        if not interval or now - self._last_scrub < interval:
            return
        self._last_scrub = now
        m = self.osdmap
        if m is None:
            return
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                try:
                    _acting, primary = self._acting(pool_id, ps)
                except KeyError:
                    continue
                if primary != self.id:
                    continue
                pgid = f"{pool_id}.{ps}"
                if pgid in self._scrubs_queued:
                    continue  # scrubs outlasting the interval must not pile
                self._scrubs_queued.add(pgid)

                def scrub_work(pid=pool_id, s=ps, key=pgid):
                    try:
                        self.scrub_pg(pid, s)
                    finally:
                        self._scrubs_queued.discard(key)

                self.scheduler.enqueue("background_scrub", scrub_work)

    def _mgr_report(self) -> None:
        """Stream a perf snapshot to the mgr (reference: MgrClient sending
        MMgrReport on its tick)."""
        addr = self.cct.conf.get("mgr_addr")
        if not addr:
            return
        from ..common.kernel_telemetry import backend_health
        from ..mgr.messages import MMgrReport

        host, _, port = addr.rpartition(":")
        with self._pgs_lock:
            num_pgs = len(self.pgs)
        # the store scan runs UNLOCKED: heartbeats/recovery/map-apply all
        # contend on _pgs_lock, and an O(objects) walk per report tick
        # must not delay them toward the failure-report threshold
        num_objects = 0
        pool_bytes: dict[int, int] = {}
        pool_objects: dict[int, int] = {}
        coll_objects: dict[str, int] = {}  # cid -> objects (pg rows below)
        try:
            coll_bytes = self.store.collections_bytes()  # one index pass
        except Exception:
            coll_bytes = {}
        for cid in self.store.list_collections():
            pool_id = None
            if "." in cid:
                try:
                    pool_id = int(cid.split(".", 1)[0])
                except ValueError:
                    pool_id = None
            try:
                n_here = sum(
                    1 for o in self.store.list_objects(cid)
                    if not o.startswith("_")
                )
            except Exception as e:
                # collection dropped concurrently (split cleanup) —
                # count what's still listable, but leave a trace
                self.cct.dout("osd", 10,
                              f"{self.whoami} stats skipped {cid}: {e!r}")
                continue
            coll_objects[cid] = n_here
            num_objects += n_here
            if pool_id is not None:
                pool_bytes[pool_id] = (
                    pool_bytes.get(pool_id, 0) + coll_bytes.get(cid, 0)
                )
                pool_objects[pool_id] = (
                    pool_objects.get(pool_id, 0) + n_here
                )
        self.logger.set("numpg", num_pgs)
        # per-PG status rows, PRIMARY-reported so each PG has exactly one
        # author (reference: pg_stat_t streamed inside MMgrReport)
        pg_info: dict[str, dict] = {}
        m = self.osdmap
        if m is not None:
            with self._pgs_lock:
                snapshot = list(self.pgs.values())
            for pg in snapshot:
                pool = m.pools.get(pg.pool_id)
                if pool is None:
                    continue
                try:
                    up, _upp, acting, prim = m.pg_to_up_acting_osds(
                        pg.pool_id, pg.ps)
                except (KeyError, IndexError, ValueError):
                    continue
                if prim != self.id:
                    continue
                # a PG that has never seen an interval CHANGE never runs
                # the peering round — activated_interval stays -1 from
                # birth.  That is healthy ONLY while interval_start is
                # still 0; once an interval change lands, -1 means the
                # first peering round hasn't finished and ops are being
                # refused (primary_ops gates on activated==interval_start)
                peered = (pg.activated_interval == pg.interval_start
                          or (pg.activated_interval < 0
                              and pg.interval_start == 0))
                # cephheal pg_stats: object count of the primary's own
                # shard collection (reusing the store walk above), plus
                # degraded/misplaced object-copy counts — down or
                # absent acting slots degrade every object LIVE (no
                # recovery pass needed to see a kill), and the recovery
                # pass's missing-on-live-peers count rides on top
                is_ec = pool.type == PG_POOL_ERASURE
                try:
                    my_shard = acting.index(self.id) if is_ec else 0
                except ValueError:
                    my_shard = 0
                n_obj = coll_objects.get(self._cid(pg.pgid, my_shard), 0)
                # missing copies = pool.size minus LIVE members: counts
                # both EC's positional -1 holes and replicated pools'
                # COMPACTED acting lists (a down replica is dropped
                # from acting entirely, never a -1 slot)
                live_members = sum(
                    1 for o in acting if o >= 0 and m.is_up(o))
                down_slots = max(0, pool.size - live_members)
                degraded = (n_obj * down_slots
                            + int(getattr(pg, "stat_degraded_peers", 0)))
                misplaced = n_obj * sum(
                    1 for a, u in zip(acting, up) if a != u)
                if peered:
                    if down_slots:
                        state = "active+degraded"
                    elif degraded:
                        state = "active+recovering+degraded"
                    else:
                        state = "active+clean"
                else:
                    state = "peering"
                pg_info[pg.pgid] = {
                    "state": state,
                    "version": pg.version,
                    "objects": n_obj,
                    "degraded": degraded,
                    "misplaced": misplaced,
                }
        try:
            self.messenger.connect((host, int(port))).send_message(
                MMgrReport(
                    daemon=self.whoami,
                    counters=self.cct.perf.dump(),
                    # counter docs/types ride along so the prometheus
                    # exporter emits real HELP text and histogram TYPEs
                    schema=self.cct.perf.schema(),
                    epoch=self.my_epoch(),
                    stats={"num_pgs": num_pgs, "num_objects": num_objects,
                           "pool_bytes": {
                               str(k): v for k, v in pool_bytes.items()
                           },
                           "pool_objects": {
                               str(k): v for k, v in pool_objects.items()
                           },
                           "statfs": self.store.statfs(),
                           # sticky count: in-flight slow PLUS recently
                           # completed slow (cephmeter — a straggler
                           # finishing between report polls must not
                           # vanish from SLOW_OPS before the digest
                           # samples it)
                           "slow_ops": self.op_tracker.slow_op_count(),
                           "slow_ops_detail":
                               self.op_tracker.slow_summaries(),
                           # accelerator health rides the same stream
                           # SLOW_OPS does: mgr digest -> mon _health
                           "backend_health": backend_health(),
                           # cephheal: PGs whose recovery pass has
                           # raised >= 3 consecutive ticks — surfaced
                           # in RECOVERY_STALLED instead of scrolling
                           # away at dout level 1
                           "recovery_failing": self._failing_pgs(),
                           "pg_info": pg_info},
                )
            )
        except (OSError, ConnectionError, ValueError):
            pass  # mgr down: retry next interval

    def _failing_pgs(self, threshold: int = 3) -> dict:
        """{pgid: {"count", "error"}} for PGs whose _recover_pg has
        raised `threshold`+ consecutive ticks (reset on a clean pass)."""
        with self._lock:
            return {
                pgid: {"count": ent[0], "error": ent[1]}
                for pgid, ent in self._recovery_failures.items()
                if ent[0] >= threshold
            }

    def _heartbeat(self) -> None:
        """Ping peers sharing PGs with us (reference: OSD::heartbeat);
        after osd_heartbeat_grace seconds of silence (grace/interval
        intervals) report the peer to the mon (§5.3)."""
        m = self.osdmap
        if m is None:
            return
        interval = float(self.cct.conf.get("osd_heartbeat_interval"))
        grace = float(self.cct.conf.get("osd_heartbeat_grace"))
        silent_limit = max(1, round(grace / max(interval, 1e-9)))
        peers: set[int] = set()
        with self._pgs_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            try:
                acting, _ = self._acting(pg.pool_id, pg.ps)
            except KeyError:
                continue
            peers |= {o for o in acting if o >= 0 and o != self.id}
        for osd in peers:
            if not m.is_up(osd):
                continue
            prev = self._hb_failures.get(osd, 0)
            try:
                self._conn_to_osd(osd).send_message(
                    MOSDPingMsg(op="ping", osd=self.id, epoch=self.my_epoch())
                )
                self._hb_failures[osd] = prev + 1
            except (OSError, ConnectionError):
                self._hb_failures[osd] = prev + 1
            if self._hb_failures.get(osd, 0) >= silent_limit:
                self.mc.report_failure(osd, failed_for=grace)
                # remember the report so a later ping reply retracts it
                # (MOSDAlive) instead of leaving a stale corroboration
                # entry on the leader
                self._hb_reported.add(osd)
                # restart the count: re-report only after another full
                # grace of silent intervals, not on every subsequent tick
                self._hb_failures.pop(osd, None)

