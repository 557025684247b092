"""Peering-lite, delta recovery, backfill, and stray-shard probing (reference: src/osd/PeeringState.cc + ECBackend recovery).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations


import time

import numpy as np

from ..common.crc32c import crc32c
from ..common.device import to_host
from ..ec.interface import InsufficientChunks
from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.tracer import TRACER, TraceCtx, op_trace, set_op_trace, \
    trace_now
from ..store.object_store import NotFound
from .messages import (
    MECSubOpRead,
    MECSubOpWrite,
    MPGClean,
    MPGPull,
    MPGPullReply,
    MPGQuery,
    pack_data,
    unpack_data,
)
from ..osd.osdmap import PG_POOL_ERASURE
from ..osd.osdmap import OSDMap  # noqa: F401 (annotations)
from .pg import _current_generation, PGState

#: seconds a PG whose last recovery pass found it clean goes unqueried
#: while nothing that could unclean it has changed: its interval and
#: activation, its version, the pool's pg_num, its acting set and those
#: members' addresses (a revived OSD comes back at a new one).  Every
#: primary's pass otherwise queries every peer of every PG each second,
#: which in a LocalCluster of 12 OSDs holds the interpreter lock so busy
#: that a mgr's placement scan took minutes (PERF.md, PR 10).  A peer
#: that loses data with none of those changing is found within this
#: many seconds, or by scrub.
CLEAN_REPOLL_S = 30.0


def _clean_key(pg: PGState, pool, acting: list[int], m) -> tuple:
    return (pg.interval_start, pg.activated_interval, pg.version,
            pool.pg_num, tuple(acting),
            tuple(tuple(m.osd_addrs.get(o) or ()) for o in acting))


def prune_costly_helpers(avail: set[int], acting: list[int],
                         my_shard: int, peer_load: dict,
                         now: float, ttl: float,
                         max_qlen: int) -> set[int]:
    """Drop helper shards whose owner OSD measured EXPENSIVE in the
    freshest piggybacked sub-op telemetry (cephstorm; ROADMAP repair
    residual): a helper is dropped only when its `_peer_load` row is
    fresh (<= ttl old) AND reports a degraded backend sentinel or an
    mClock queue at/over `max_qlen`.  Shards without fresh telemetry
    are KEPT — with no telemetry at all the result equals `avail`, so
    the codec's default index-order plan is unchanged.  `my_shard` is
    never dropped (it anchors generation/size locally, costing no
    network read).  Pure: unit-testable without a daemon."""
    keep = set()
    for s in avail:
        if s == my_shard:
            keep.add(s)
            continue
        rec = peer_load.get(acting[s])
        if rec is None or now - rec[0] > ttl:
            keep.add(s)
            continue
        _ts, qlen, degraded = rec
        if degraded or qlen >= max_qlen:
            continue
        keep.add(s)
    return keep


class RecoveryMixin:
    # -- recovery (peering-lite, primary only) ----------------------------
    def _recover_all(self) -> None:
        m = self.osdmap
        if m is None:
            return
        # discover PGs I'm primary for (incl. ones with no local data yet)
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                try:
                    acting, primary = self._acting(pool_id, ps)
                except KeyError:
                    continue
                if primary != self.id or self.id not in acting:
                    continue
                pg = self._pg(pool_id, ps)
                if (pg.clean_key == _clean_key(pg, pool, acting, m)
                        and time.monotonic() - pg.clean_at < CLEAN_REPOLL_S):
                    continue
                # NO pg.lock here: _recover_pg's pull phase waits on the
                # donor's sub-writes, which our dispatch thread can only
                # apply after taking pg.lock — holding it across the pull
                # self-deadlocks.  _recover_pg locks its push phase.
                try:
                    self._recover_pg(pg, pool, acting)
                    with self._lock:
                        self._recovery_failures.pop(pg.pgid, None)
                except FailpointCrash:
                    # a simulated abort must propagate like a real one
                    # (the failpoint contract) — never count as a
                    # recoverable per-PG failure
                    raise
                except Exception as e:
                    # cephheal: a per-tick failure is a counted,
                    # traced, health-visible event — not a dout line
                    # that scrolls away (satellite: repeat-failing PGs
                    # surface in RECOVERY_STALLED via _mgr_report)
                    self.logger.inc("recovery_errors")
                    TRACER.tracepoint(
                        "recovery", "error", entity=self.whoami,
                        pgid=pg.pgid, error=repr(e))
                    with self._lock:
                        ent = self._recovery_failures.setdefault(
                            pg.pgid, [0, ""])
                        ent[0] += 1
                        ent[1] = repr(e)
                    self.cct.dout(
                        "osd", 1,
                        f"{self.whoami} recover {pg.pgid}: {e!r}",
                    )

    def _rebuild_intervals_from_maps(self, pg: PGState, start: int,
                                     until: int | None = None) -> None:
        """Reconstruct interval history from the mon's stored maps
        (reference: PastIntervals::check_new_interval walked over past
        OSDMaps via OSDService::get_map).  A revived OSD's in-memory
        tracking saw nothing while it was down, and a freshly-assigned
        primary only started recording at its own PG creation; the maps
        saw everything.  Rebuilds the closures over [start, until) and
        PREPENDS them to whatever in-memory history already exists."""
        from .past_intervals import PastIntervals

        cur = self.my_epoch()
        until = cur if until is None else min(until, cur)
        start = max(1, start)
        if until - start > 512:
            start = until - 512  # bound mon fetches on huge gaps
        # batched fetch: ~8 round trips for the full 512-epoch bound
        # instead of one command per epoch (review r4)
        fetched: dict[int, dict] = {}
        e = start
        while e <= until:
            if self.osdmap is not None and e == self.osdmap.epoch:
                e += 1
                continue
            try:
                rv, res = self.mc.command(
                    {"prefix": "osd getmaps", "first": e, "last": until},
                    timeout=10.0,
                )
            except (OSError, ConnectionError):
                return  # mon unreachable: retry next pass
            if rv != 0:
                return
            fetched.update(
                {int(k): v for k, v in res.get("maps", {}).items()}
            )
            e = int(res.get("last", e)) + 1
        rebuilt = PastIntervals()
        prev = None
        prev_ua = None
        first = start
        for e in range(start, until + 1):
            if self.osdmap is not None and e == self.osdmap.epoch:
                m = self.osdmap
            else:
                j = fetched.get(e)
                if j is None:
                    continue  # epoch gap (paxos-trimmed): skip
                m = OSDMap.from_json(j, device=self.device)
            try:
                ua = m.pg_to_up_acting_osds(pg.pool_id, pg.ps)
            except Exception:
                prev, prev_ua = m, None
                continue
            if prev_ua is not None and (prev_ua[2], prev_ua[3]) != \
                    (ua[2], ua[3]):
                pool = prev.pools.get(pg.pool_id)
                went_rw = (
                    prev_ua[3] >= 0
                    and pool is not None
                    and sum(1 for a in prev_ua[2] if a >= 0) >= pool.min_size
                )
                rebuilt.add(
                    first=first, last=m.epoch - 1,
                    up=prev_ua[0], acting=prev_ua[2], primary=prev_ua[3],
                    maybe_went_rw=went_rw,
                )
                first = m.epoch
            prev, prev_ua = m, ua
        pg.intervals_rebuilt = True
        if rebuilt:
            from .past_intervals import MAX_INTERVALS

            # keep the NEWEST MAX_INTERVALS — direct assignment must not
            # bypass add()'s growth cap (review r4)
            pg.past_intervals.intervals = (
                rebuilt.intervals + pg.past_intervals.intervals
            )[-MAX_INTERVALS:]
            self.cct.dout(
                "osd", 1,
                f"{self.whoami} {pg.pgid} rebuilt "
                f"{len(rebuilt.intervals)} past interval(s) from maps "
                f"[{start},{until}]",
            )
            self._save_intervals(pg)

    def _recover_pg(self, pg: PGState, pool, acting: list[int]) -> None:
        """cephheal wrapper: one recovery pass = one traceable,
        TrackedOp-registered background op.  The ctx is born HERE (the
        recovery analog of op_submit) with the same head-coin-flip +
        tail-provisional contract, so a slow recovery keeps its
        connected tree at trace_sampling_rate=0; the TrackedOp
        (src="recovery") puts multi-second pulls into
        dump_historic_slow_ops.  The body is _recover_pg_inner —
        exceptions propagate to _recover_all's error accounting."""
        # "osd.recovery.tick": an error action fails this PG's whole
        # pass at the top of every tick — the deterministic driver for
        # the repeat-failing-PG health surface (docs/fault_injection.md)
        failpoint("osd.recovery.tick", cct=self.cct, entity=self.whoami,
                  pgid=pg.pgid)
        ctx = self._bg_trace_ctx()
        root = None
        if ctx is not None:
            root = TRACER.begin(ctx, "recovery", entity=self.whoami,
                                pgid=pg.pgid)
        tracked = self.op_tracker.create(
            f"recovery({pg.pgid})", src="recovery")
        tracked.trace_id = ctx.trace_id if ctx is not None else None
        prev = op_trace()
        set_op_trace({
            "ctx": root.ctx() if root is not None else ctx,
            "tracked": tracked,
        })
        try:
            self._recover_pg_inner(pg, pool, acting)
        finally:
            set_op_trace(prev)
            TRACER.end(root)
            tracked.finish()
            if TRACER.enabled and tracked.trace_id is not None:
                self._bg_tail_verdict(tracked)

    def _recover_pg_inner(self, pg: PGState, pool,
                          acting: list[int]) -> None:
        is_ec = pool.type == PG_POOL_ERASURE
        codec = self._codec_for_pool(pool) if is_ec else None
        pg.clean_key = None
        m_entry, version_at_entry = self.osdmap, pg.version
        # one query round: peer versions + object lists drive the
        # authoritative-log pull, the per-peer classification, and
        # delete propagation
        peers: dict[tuple[int, int], tuple[int, list]] = {}
        peer_epochs: list[int] = []
        t_peer0 = trace_now()
        queried = 0
        for shard, osd in enumerate(acting):
            if osd < 0 or osd == self.id or not self.osdmap.is_up(osd):
                continue
            # replicated replicas all store in the s0 collection; only EC
            # shards have per-shard collections
            store_shard = shard if is_ec else 0
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MPGQuery(tid=tid, pgid=pg.pgid, shard=store_shard,
                             epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                continue
            queried += 1
            rep = self._wait_reply(tid, timeout=5.0)
            if rep is None or rep.version is None:
                continue
            peers[(shard, osd)] = (rep.version, rep.oids or [])
            e = getattr(rep, "last_epoch", None)
            if e:
                peer_epochs.append(int(e))
        if queried:
            # sampled only when a query actually went out — the
            # every-tick idle pass must not drown the histogram
            self._bg_stage("recovery_peer", t_peer0, trace_now(),
                           peers=len(peers), queried=queried)
        interval_at_entry = pg.interval_start
        # history rebuild (reference: pg_history_t carried in notifies +
        # PastIntervals built over past OSDMaps): when this primary has
        # no interval history but the PG demonstrably has a past — its
        # own or any peer's last-write epoch predates the current
        # interval — fetch the intervening maps from the mon and
        # reconstruct the closed intervals before judging anything.
        # Covers both the revived stale OSD (its own epoch is old) and
        # the freshly-assigned empty primary (a peer's epoch is old) —
        # even one that already recorded SOME closures of its own: the
        # rebuild fills the prefix its in-memory tracking predates.
        known = [e for e in ([pg.last_map_epoch] + peer_epochs) if e]
        hist_floor = (
            pg.past_intervals.intervals[0]["first"]
            if pg.past_intervals else pg.interval_start
        )
        if (
            not pg.intervals_rebuilt
            and known
            and min(known) < hist_floor
        ):
            self._rebuild_intervals_from_maps(
                pg, start=min(known), until=hist_floor
            )
        # choose_acting beyond the acting set (reference: build_prior +
        # choose_acting over PastIntervals): members of past rw
        # intervals may hold a log NEWER than anything the current
        # acting set has — query them too, bounded by the history
        strays: dict[tuple[int, int], int] = {}
        queried = {self.id} | {osd for (_s, osd) in peers}
        prior = pg.past_intervals.query_candidates(
            exclude={-1, self.id} | {o for o in acting if o >= 0},
            is_up=self.osdmap.is_up,
        )
        for osd, p_shard in prior.items():
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MPGQuery(tid=tid, pgid=pg.pgid,
                             shard=p_shard if is_ec else 0,
                             epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid, timeout=5.0)
            if rep is None or rep.version is None:
                continue
            queried.add(osd)
            strays[(p_shard, osd)] = rep.version
        # build_prior activation block: a past rw interval NONE of whose
        # members answered may hold the authoritative log — activating
        # anyway could serve a stale/forked history (the exact failure
        # generation floors cannot see).  Stay inactive and retry.
        blocked = pg.past_intervals.blocked_by(queried)
        if blocked:
            iv = blocked[0]
            self.cct.dout(
                "osd", 1,
                f"{self.whoami} {pg.pgid} peering blocked: interval "
                f"[{iv['first']},{iv['last']}] acting {iv['acting']} "
                f"went rw and no member is reachable",
            )
            return
        # phase 0 — adopt the authoritative log (reference: peering's
        # choose_acting/authoritative-log step): a primary revived after
        # missing writes must catch ITSELF up first, else it would mint
        # duplicate versions on the next write and wrongly judge
        # ahead-peers clean (wait_clean compares against the primary).
        # Runs WITHOUT pg.lock: the donor's catch-up arrives as
        # MECSubOpWrites our dispatch thread applies under that lock.
        ahead = {k: v for k, (v, _o) in peers.items() if v > pg.version}
        stray_newest = max(strays.values(), default=0)
        if stray_newest > max([pg.version, *ahead.values()]):
            if is_ec:
                # an EC stray proves newer writes exist, but a non-acting
                # donor cannot push shard-correct chunks (the donor path
                # reads by its acting index) — stay INACTIVE rather than
                # activate on a log we know is stale; the PG heals when
                # the stray rejoins acting or an acting member catches up
                self.cct.dout(
                    "osd", 1,
                    f"{self.whoami} {pg.pgid} stale vs stray holders "
                    f"(v{stray_newest} > v{pg.version}); deferring "
                    f"activation",
                )
                return
            # replicated: the past-interval holder IS the authoritative
            # log donor even though it is not acting (choose_acting
            # electing a stray; every replica is shard 0, so the pull
            # path needs no shard translation)
            ahead = {
                k: v for k, v in strays.items() if v == stray_newest
            }
        if ahead:
            (_b_shard, b_osd), _bv = max(ahead.items(), key=lambda kv: kv[1])
            my_shard = acting.index(self.id) if is_ec else 0
            try:
                my_oids = [
                    o for o in self.store.list_objects(
                        self._cid(pg.pgid, my_shard))
                    if not o.startswith("_")
                ]
            except (NotFound, KeyError):
                my_oids = []
            tid = self._next_tid()
            # span opened BEFORE the send so the MPGPull carries its id
            # as parent — the donor's rebuild/push spans join THIS node
            # (the subop fan-out pattern)
            pull_span = TRACER.begin(
                self._op_trace_ctx(), "recovery_pull",
                entity=self.whoami, donor=f"osd.{b_osd}",
            ) if TRACER.enabled else None
            t_pull0 = pull_span.t0 if pull_span is not None else trace_now()
            try:
                self._conn_to_osd(b_osd).send_message(MPGPull(
                    tid=tid, pgid=pg.pgid, shard=my_shard,
                    from_version=pg.version, epoch=self.my_epoch(),
                    have_oids=my_oids,
                    trace_id=(pull_span.trace_id
                              if pull_span is not None else None),
                    parent_span=(pull_span.span_id
                                 if pull_span is not None else None),
                ))
                rep = self._wait_reply(tid, timeout=30.0)
            except (OSError, ConnectionError):
                rep = None
            self._bg_stage(
                "recovery_pull", t_pull0, trace_now(), span=pull_span,
                donor=f"osd.{b_osd}",
                retval=rep.retval if rep is not None else None)
            if rep is not None and rep.retval == 0:
                self.cct.dout(
                    "osd", 1,
                    f"{self.whoami} pulled {pg.pgid} forward to "
                    f"v{pg.version} from osd.{b_osd}",
                )
            else:
                return  # retry next tick; judging peers now would be wrong
        # peered: no peer is ahead (or we just adopted the ahead log) —
        # this primary may now serve ops for the current interval
        pg.activated_interval = interval_at_entry
        acting_members = {o for o in acting if o >= 0 and o != self.id}
        answered = acting_members <= {osd for (_s, osd) in peers}
        if pg.version == 0:
            # nothing written yet; clean if no peer holds anything either
            if answered and not any(v or oids for v, oids in peers.values()):
                self._mark_clean(pg, pool, acting, m_entry, version_at_entry,
                                 interval_at_entry)
            return
        my_shard = acting.index(self.id) if is_ec else 0
        my_cid = self._cid(pg.pgid, my_shard)

        def _my_oids() -> set:
            try:
                return {
                    o for o in self.store.list_objects(my_cid)
                    if not o.startswith("_")
                }
            except (NotFound, KeyError):
                return set()

        my_oids = _my_oids()
        # phase 0.5 — SELF role-heal: an acting permutation can hand this
        # primary a shard role it never held; every peer below is judged
        # against MY collection, so an empty one would read as
        # everything-clean while the primary serves nothing.  Pull full
        # content from an up-to-date peer — the donor's backfill push
        # carries data + xattrs + omap and deletes my stale extras
        # (reference: the primary recovers itself first in
        # PeeringState::activate / recovery_state).
        peer_union: set = set()
        for (_v, oids) in peers.values():
            peer_union.update(oids)
        if peer_union - my_oids:
            donor = next(
                (osd for (shard, osd), (v, _o) in peers.items()
                 if v >= pg.version),
                None,
            )
            if donor is not None:
                self.cct.dout(
                    "osd", 1,
                    f"{self.whoami} self role-heal {pg.pgid} shard "
                    f"{my_shard}: {len(peer_union - my_oids)} objects "
                    f"from osd.{donor}",
                )
                tid = self._next_tid()
                heal_span = TRACER.begin(
                    self._op_trace_ctx(), "recovery_pull",
                    entity=self.whoami, donor=f"osd.{donor}",
                    role_heal=True,
                ) if TRACER.enabled else None
                t_heal0 = (heal_span.t0 if heal_span is not None
                           else trace_now())
                try:
                    self._conn_to_osd(donor).send_message(MPGPull(
                        tid=tid, pgid=pg.pgid, shard=my_shard,
                        from_version=0, epoch=self.my_epoch(),
                        have_oids=sorted(my_oids),
                        trace_id=(heal_span.trace_id
                                  if heal_span is not None else None),
                        parent_span=(heal_span.span_id
                                     if heal_span is not None else None),
                    ))
                    self._wait_reply(tid, timeout=30.0)
                except (OSError, ConnectionError):
                    pass
                self._bg_stage("recovery_pull", t_heal0, trace_now(),
                               span=heal_span, donor=f"osd.{donor}",
                               role_heal=True)
                my_oids = _my_oids()
        # cephheal pg_stats: object-copies this PG's LIVE peers are
        # missing (down/absent shards are counted live by _mgr_report
        # from its store walk — this is the recoverable-by-push half
        # the report cannot see).  Per-pass granularity; the push
        # helpers decrement as objects land so a long backfill drains
        # visibly between passes.
        degraded = 0
        for (shard, osd), (peer_ver, peer_oids) in peers.items():
            role_missing_n = len(my_oids - set(peer_oids))
            if peer_ver >= pg.version:
                degraded += role_missing_n
            elif pg.log.covers(peer_ver):
                newest, _d = pg.log.missing_since(peer_ver)
                degraded += max(len(newest), role_missing_n)
            else:
                degraded += max(len(my_oids), role_missing_n)
        pg.stat_degraded_peers = degraded
        # push phase: serialize vs concurrent client writes on this PG
        all_clean = True
        with pg.lock:
            for (shard, osd), (peer_ver, peer_oids) in peers.items():
                role_missing = my_oids - set(peer_oids)
                if peer_ver >= pg.version and not role_missing:
                    continue  # clean
                all_clean = False
                if peer_ver >= pg.version:
                    # version-current but the SHARD ROLE's objects are
                    # absent: an acting-set permutation (OSD out -> CRUSH
                    # reshuffle) handed this OSD a shard it never held —
                    # the per-PG version cannot see that, only the
                    # contents comparison can.  Rebuild its new role's
                    # chunks (and retire any stale leftovers in that
                    # collection from an older interval).
                    self.cct.dout(
                        "osd", 1,
                        f"{self.whoami} role-backfill {pg.pgid} shard "
                        f"{shard} osd.{osd}: {len(role_missing)} objects",
                    )
                    t_rb0 = trace_now()
                    self._push_objects(
                        pg, codec, acting, shard if is_ec else 0, osd,
                        {o: None for o in sorted(role_missing)},
                        set(peer_oids) - my_oids, is_ec,
                    )
                    self._bg_stage("recovery_push", t_rb0, trace_now(),
                                   peer=f"osd.{osd}", shard=shard,
                                   mode="role_backfill",
                                   objects=len(role_missing))
                else:
                    self._push_missing(
                        pg, codec, acting, shard if is_ec else 0, osd,
                        peer_ver, is_ec, peer_oids,
                    )
        if all_clean:
            pg.stat_degraded_peers = 0
        if all_clean and answered:
            self._mark_clean(pg, pool, acting, m_entry, version_at_entry,
                             interval_at_entry)
        # prune the interval history once the PG is CLEAN in the current
        # interval (reference: last_epoch_clean).  "Clean" demands a
        # FULL acting set in which every member answered and needed no
        # push — a degraded PG keeps its history: those unheard members
        # are exactly what the history exists to track (review r4).
        # The clean point is BROADCAST to the acting replicas (MPGClean)
        # so their persisted rebuild floors advance too — otherwise a
        # later primary rebuilding from a replica's stale last-write
        # epoch would resurrect already-settled intervals whose members
        # are long gone and block activation forever (review r4).
        if (
            all_clean
            and all(o >= 0 for o in acting)
            and answered
            and (pg.past_intervals
                 or pg.clean_broadcast_interval != interval_at_entry)
        ):
            epoch = self.my_epoch()
            # under the pg lock: _log_txn (op worker, holding pg.lock)
            # writes last_map_epoch concurrently, and this max() is a
            # read-modify-write (cephrace CR1 write-write).  The store
            # txn below stays OUTSIDE the lock (blocking under a lock is
            # CL1's business)
            with pg.lock:
                pg.past_intervals.clear()
                pg.last_map_epoch = max(pg.last_map_epoch, epoch)
                pg.intervals_rebuilt = False
                pg.clean_broadcast_interval = interval_at_entry
            self._save_intervals(pg)
            for shard, osd in enumerate(acting):
                if osd < 0 or osd == self.id or not self.osdmap.is_up(osd):
                    continue
                try:
                    self._conn_to_osd(osd).send_message(MPGClean(
                        pgid=pg.pgid, shard=shard if is_ec else 0,
                        epoch=epoch,
                    ))
                except (OSError, ConnectionError):
                    pass  # replica re-learns at its next clean pass

    def _mark_clean(self, pg: PGState, pool, acting: list[int], m_entry,
                    version_at_entry: int, interval_at_entry: int) -> None:
        """Let the idle passes skip this PG (CLEAN_REPOLL_S) unless a
        write, an interval change or a map landed during this pass."""
        if pg.version != version_at_entry or not (
                pg.interval_start == pg.activated_interval == interval_at_entry):
            return
        key = _clean_key(pg, pool, acting, m_entry)
        if key == _clean_key(pg, pool, acting, self.osdmap):
            pg.clean_key, pg.clean_at = key, time.monotonic()

    def _push_missing(self, pg, codec, acting, dest_shard, dest_osd,
                      from_version, is_ec, dest_oids) -> bool:
        """Classify delta vs backfill, push, seal — shared by the primary
        push loop and the pull donor; one `recovery_push` stage sample /
        span per round, whichever side runs it (cephheal)."""
        t0 = trace_now()
        ok = self._push_missing_inner(
            pg, codec, acting, dest_shard, dest_osd, from_version,
            is_ec, dest_oids,
        )
        self._bg_stage(
            "recovery_push", t0, trace_now(), peer=f"osd.{dest_osd}",
            shard=dest_shard, ok=ok,
            mode="delta" if pg.log.covers(from_version) else "backfill")
        return ok

    def _push_missing_inner(self, pg, codec, acting, dest_shard, dest_osd,
                            from_version, is_ec, dest_oids) -> bool:
        """Counters are started/completed
        pairs: stat_delta_recoveries / stat_backfills count rounds
        STARTED (race-free for observers — an ack lost after the peer
        applied would leave a completed-only counter at zero), the
        *_completed twins count fully acked rounds."""
        my_shard = acting.index(self.id) if is_ec else 0
        if pg.log.covers(from_version):
            self.cct.dout(
                "osd", 1,
                f"{self.whoami} delta-recovery {pg.pgid} "
                f"shard {dest_shard} osd.{dest_osd} from v{from_version}",
            )
            pg.stat_delta_recoveries = getattr(
                pg, "stat_delta_recoveries", 0) + 1
            ok = self._push_log_delta(
                pg, codec, acting, dest_shard, dest_osd, from_version, is_ec
            )
            if ok:
                self._bump_peer_version(pg, dest_shard, dest_osd, pg.version)
                pg.stat_delta_completed = getattr(
                    pg, "stat_delta_completed", 0) + 1
            return ok
        # log too old: full backfill of this shard.  Versions are
        # unknowable per object (trimmed), so chunks are pushed
        # unversioned and the final sync entry seals the version.  The
        # target's extra objects (deleted here after its log horizon)
        # get data-less deletes — a survivors-only push would resurrect
        # deletions when the target is later trusted.
        try:
            oids = [
                o for o in self.store.list_objects(
                    self._cid(pg.pgid, my_shard))
                if not o.startswith("_")
            ]
        except (NotFound, KeyError):
            oids = []
        deleted = set(dest_oids or []) - set(oids)
        self.cct.dout(
            "osd", 1,
            f"{self.whoami} backfill {pg.pgid} shard {dest_shard} "
            f"osd.{dest_osd}: {len(oids)} objects, "
            f"{len(deleted)} deletions",
        )
        pg.stat_backfills = getattr(pg, "stat_backfills", 0) + 1
        ok = self._push_objects(
            pg, codec, acting, dest_shard, dest_osd,
            {o: None for o in oids}, deleted, is_ec,
        )
        if ok:
            self._bump_peer_version(pg, dest_shard, dest_osd, pg.version)
            pg.stat_backfill_completed = getattr(
                pg, "stat_backfill_completed", 0) + 1
        return ok

    def _handle_pg_pull(self, conn, msg: MPGPull) -> None:
        """An ahead peer serving a stale primary's catch-up request: push
        my log delta (or full objects + deletions when my log was
        trimmed) to the requester, then seal its version (the
        authoritative-log donor role in peering).  Runs under MY pg.lock
        so a concurrent write cannot advance the version mid-push and
        let the seal vouch for entries never sent; the requester holds
        no lock while waiting, so there is no cross-OSD lock cycle."""
        retval = -5
        # cephheal: the donor's half of the recovery tree — its rebuild
        # and push spans parent to the requester's recovery_pull span
        # carried on the wire, and the work rides a src="recovery"
        # TrackedOp so a multi-second donor push is slow-op-visible
        donor_span = None
        if TRACER.enabled and getattr(msg, "trace_id", None) is not None:
            donor_span = TRACER.begin(
                TraceCtx(msg.trace_id, msg.parent_span), "recovery_donor",
                entity=self.whoami, pgid=msg.pgid, requester=msg.src,
            )
        tracked = self.op_tracker.create(
            f"recovery_donor({msg.pgid} -> {msg.src})", src="recovery")
        tracked.trace_id = getattr(msg, "trace_id", None)
        prev = op_trace()
        set_op_trace({
            "ctx": donor_span.ctx() if donor_span is not None else None,
            "tracked": tracked,
        })
        try:
            # "osd.recovery.pull": an error action makes this donor fail
            # the catch-up request (the requester retries next pass,
            # possibly from another peer)
            failpoint("osd.recovery.pull", cct=self.cct,
                      entity=self.whoami, pgid=msg.pgid)
            pool_id, ps = msg.pgid.split(".")
            pg = self._pg(int(pool_id), int(ps))
            pool = self.osdmap.pools.get(int(pool_id))
            requester = (
                int(msg.src.split(".", 1)[1])
                if msg.src.startswith("osd.") else None
            )
            if pool is None or requester is None:
                raise ValueError(f"bad pull {msg.src} {msg.pgid}")
            acting, _p = self._acting(int(pool_id), int(ps))
            is_ec = pool.type == PG_POOL_ERASURE
            codec = self._codec_for_pool(pool) if is_ec else None
            from_v = int(msg.from_version or 0)
            with pg.lock:
                if pg.version <= from_v:
                    retval = 0  # nothing newer here
                else:
                    ok = self._push_missing(
                        pg, codec, acting, msg.shard, requester, from_v,
                        is_ec, msg.have_oids,
                    )
                    retval = 0 if ok else -5
        except FailpointCrash:
            raise
        except Exception as e:
            self.cct.dout(
                "osd", 0, f"{self.whoami} pg pull failed: {e!r}"
            )
        finally:
            set_op_trace(prev)
            TRACER.end(donor_span, retval=retval)
            tracked.finish()
            if TRACER.enabled and tracked.trace_id is not None \
                    and self.op_tracker.complaint_time > 0 \
                    and tracked.duration() > self.op_tracker.complaint_time:
                # promote only — the requester's verdict owns the
                # discard (promote wins over discard)
                TRACER.promote(tracked.trace_id, reason="recovery_donor")
        try:
            conn.send_message(MPGPullReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard,
                retval=retval,
                trace_id=getattr(msg, "trace_id", None),
                parent_span=getattr(msg, "parent_span", None),
            ))
        except (OSError, ConnectionError):
            pass

    def _push_sub_write(self, pg, osd, shard, oid, data, version, entry,
                        src_cid: str | None = None,
                        osize: int | None = None) -> bool:
        """One recovery push; True iff the peer acked it (retval 0).
        Data pushes copy the object's user xattrs from `src_cid` (the
        primary's own shard collection) so a recovered shard can answer
        getxattrs after a primary move.  They also carry the primary's
        stored chunk-generation stamp (`over`): the pushed bytes are
        rebuilt-CURRENT, and stamping the log-entry version instead
        would diverge from undisturbed shards whenever the log advanced
        through xattr-only modifies (which don't change stripe bytes)."""
        xattrs = None
        gen = None
        omap = None
        if data is not None and src_cid is not None:
            gen = self._stored_ver(src_cid, oid)
            try:
                mine = self.store.getattrs(src_cid, oid)
            except (NotFound, KeyError):
                mine = {}
            # always a dict (may be empty): the receiver treats it as the
            # FULL snapshot, clearing stale attrs a removal left behind
            xattrs = {
                n[2:]: pack_data(v)
                for n, v in mine.items() if n.startswith("u_")
            }
            try:
                kv = self.store.omap_get(src_cid, oid)
            except (NotFound, KeyError):
                kv = {}
            # omap recovered as a full snapshot, like the xattrs — sent
            # even when empty so a replica's stale keys are cleared
            omap = {"snapshot": {k: pack_data(v) for k, v in kv.items()}}
        tid = self._next_tid()
        # cephheal: recovery pushes carry the background trace context
        # (MECSubOpWrite carries the fields), so the receiving
        # shard's replica_commit span joins the recovery tree
        ctx = self._op_trace_ctx()
        try:
            # "osd.recovery.push": an error action drops this push on the
            # floor — the object stays missing until a later pass
            failpoint("osd.recovery.push", cct=self.cct,
                      entity=self.whoami, pgid=pg.pgid, oid=oid, to=osd)
            self._conn_to_osd(osd).send_message(
                MECSubOpWrite(
                    tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                    data=pack_data(data) if data is not None else None,
                    crc=crc32c(data) if data is not None else None,
                    version=version, entry=entry, epoch=self.my_epoch(),
                    xattrs=xattrs, over=gen, osize=osize, omap=omap,
                    trace_id=ctx.trace_id if ctx is not None else None,
                    parent_span=ctx.span_id if ctx is not None else None,
                )
            )
        except FailpointCrash:
            raise
        except (FailpointError, OSError, ConnectionError):
            return False
        rep = self._wait_reply(tid, timeout=5.0)
        return rep is not None and rep.retval == 0

    def _push_log_delta(self, pg, codec, acting, shard, osd,
                        peer_version: int, is_ec: bool) -> bool:
        """Delta recovery: replay the FULL entry stream since the peer's
        version, in order, so the peer's pg_log stays contiguous and its
        covers() answer stays honest if it later becomes primary
        (reference: PGLog merge + pg_missing_t-driven recover_object).

        Data rides only the newest modify of each object; earlier modifies
        and deletes replay as log-only / delete pushes.  Returns True only
        if every push acked, so the caller never marks the peer clean past
        data it does not hold."""
        newest, _deleted = pg.log.missing_since(peer_version)
        my_cid = self._cid(
            pg.pgid, acting.index(self.id) if is_ec else 0
        )
        for e in pg.log.entries_since(peer_version):
            if e.op == "delete":
                ok = self._push_sub_write(
                    pg, osd, shard, e.oid, None, e.version, e.to_list()
                )
            elif e.op in ("modify", "attr") and newest.get(e.oid) == e.version:
                chunk, size = self._rebuild_shard_chunk(
                    pg, codec, acting, e.oid, shard, is_ec
                )
                if chunk is None:
                    # UNFOUND right now (reference: missing_loc unfound
                    # set): park THIS object but keep recovering the
                    # rest — one unrecoverable object must not wedge
                    # the whole peer's recovery.  The entry still
                    # replays (log stays contiguous); the object stays
                    # missing on the peer exactly as it is everywhere
                    # else, and a later tick retries when a source
                    # resurfaces.
                    self.cct.dout(
                        "osd", 1,
                        f"{self.whoami} recovery: {pg.pgid}/{e.oid} "
                        f"unfound, parking",
                    )
                    ok = self._push_sub_write(
                        pg, osd, shard, e.oid, None, e.version,
                        e.to_list(),
                    )
                    if not ok:
                        return False
                    continue
                ok = self._push_sub_write(
                    pg, osd, shard, e.oid, chunk, e.version,
                    e.to_list(), src_cid=my_cid, osize=size,
                )
                self.logger.inc("recovery_ops")
                if ok:
                    # live drain for the progress plane: one recovered
                    # object-copy off the degraded count
                    pg.stat_degraded_peers = max(
                        0, pg.stat_degraded_peers - 1)
            else:
                # superseded modify / clean marker: log-entry-only replay
                ok = self._push_sub_write(
                    pg, osd, shard, e.oid, None, e.version, e.to_list()
                )
            if not ok:
                return False
        return True

    def _push_objects(self, pg, codec, acting, shard, osd,
                      newest: dict[str, int | None], deleted: set[str],
                      is_ec: bool) -> bool:
        """Backfill push: chunk data for every object, unversioned (the
        trimmed log cannot vouch for per-object versions); the final
        "clean" seal establishes the peer's version and empty log window.
        The push still carries the object size (osize) so the peer can
        answer stat/padding-strip."""
        for oid in sorted(deleted):
            if not self._push_sub_write(pg, osd, shard, oid, None, None, None):
                return False
        my_cid = self._cid(
            pg.pgid, acting.index(self.id) if is_ec else 0
        )
        all_ok = True
        for oid in sorted(newest, key=lambda o: (newest[o] or 0, o)):
            chunk, size = self._rebuild_shard_chunk(
                pg, codec, acting, oid, shard, is_ec
            )
            if chunk is None:
                # unfound: park this object, recover the rest (see
                # _push_log_delta); all_ok=False keeps the peer unsealed
                # so later ticks retry
                all_ok = False
                continue
            version = newest[oid]
            entry = [version or 0, "modify", oid]
            if self._push_sub_write(
                pg, osd, shard, oid, chunk, version, entry, src_cid=my_cid,
                osize=size,
            ):
                # live drain for the progress plane (see _push_log_delta)
                pg.stat_degraded_peers = max(
                    0, pg.stat_degraded_peers - 1)
            else:
                all_ok = False
        return all_ok

    def _bump_peer_version(self, pg, shard, osd, version: int) -> None:
        """Final version/log sync after successful pushes: a data-less
        "clean" entry (ignored by missing_since) seals the peer at the
        primary's version."""
        tid = self._next_tid()
        try:
            self._conn_to_osd(osd).send_message(
                MECSubOpWrite(
                    tid=tid, pgid=pg.pgid, oid="", shard=shard,
                    data=None, crc=None, version=version,
                    entry=[version, "clean", ""],
                    epoch=self.my_epoch(),
                )
            )
            self._wait_reply(tid, timeout=5.0)
        except (OSError, ConnectionError):
            pass

    def _rebuild_shard_chunk(
        self, pg, codec, acting, oid: str, shard: int, is_ec: bool,
        exclude: set[int] | None = None,
    ) -> tuple[bytes | None, int]:
        """Recompute shard `shard`'s bytes for oid (reference:
        ECBackend::recover_object — read k chunks, re-encode).  `exclude`
        names additional shards whose data must not feed the rebuild
        (scrub-flagged rot).

        cephheal: the rebuild first follows the codec's
        minimum_to_decode plan (_plan_repair_read) — k full helper
        chunks for an MDS code, d helpers x sub-chunk ranges for CLAY —
        and only falls back to the historical gather-everything path
        when the plan cannot be satisfied (stale generations, silent
        helpers, self-heal).  Every completed rebuild lands one
        repair-bandwidth accounting record (helper reads, bytes read,
        bytes repaired) keyed by (pool, codec), and one
        `recovery_rebuild` stage sample/span."""
        t_rb0 = trace_now()
        pool = self.osdmap.pools.get(pg.pool_id) if self.osdmap else None
        clabel = self._codec_label(pool)
        my_shard = acting.index(self.id)
        if not is_ec:
            try:
                data = self.store.read(self._cid(pg.pgid, 0), oid)
            except (NotFound, KeyError):
                return None, 0
            self.recovery_acct.record_repair(
                pg.pool_id, clabel, 1, len(data), len(data))
            self._bg_stage("recovery_rebuild", t_rb0, trace_now(),
                           oid=oid, shard=shard)
            return data, len(data)
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        floor = pg.log.obj_newest.get(oid)
        planned = self._plan_repair_read(pg, codec, acting, oid, shard,
                                         exclude, floor)
        if planned is not None:
            chunk, size, reads, nbytes = planned
            self.recovery_acct.record_repair(
                pg.pool_id, clabel, reads, nbytes, len(chunk))
            self._bg_stage("recovery_rebuild", t_rb0, trace_now(),
                           oid=oid, shard=shard, planned=True,
                           helper_reads=reads)
            return chunk, size
        # include the DEST shard in the gather: the receiver lacks its
        # chunk, but the exact chunk may survive as a stray on a previous
        # holder (acting permutations) — using it directly also rescues
        # objects written degraded at exactly min_size, where fewer than
        # k OTHER chunks exist and decode alone could never recover
        want = set(range(n)) - (exclude or set())
        sizes: dict[int, int] = {}
        vers: dict[int, int | None] = {}
        got = self._gather_chunks(pg, codec, acting, oid, want, sizes=sizes,
                                  vers=vers, stray=True, floor=floor)
        read_bytes = sum(len(b) for b in got.values())
        n_reads = len(got)
        # never rebuild from a MIX of stripe generations, nor from one
        # the log proves is below the newest write
        got = _current_generation(got, vers, floor)
        if shard in got:
            try:
                size = int(self.store.getattr(
                    self._cid(pg.pgid, acting.index(self.id)), oid, "size"))
            except (NotFound, KeyError, ValueError):
                size = sizes.get(shard, next(iter(sizes.values()), 0))
            self.recovery_acct.record_repair(
                pg.pool_id, clabel, n_reads, read_bytes,
                len(got[shard]), full_gather=True)
            self._bg_stage("recovery_rebuild", t_rb0, trace_now(),
                           oid=oid, shard=shard, stray_rescue=True)
            return bytes(got[shard]), size
        if len(got) < k:
            return None, 0
        try:
            size = int(self.store.getattr(
                self._cid(pg.pgid, my_shard), oid, "size"))
        except (NotFound, KeyError, ValueError):
            # our own xattr is gone (we may be the shard being repaired):
            # any healthy peer's size xattr is authoritative
            size = next(iter(sizes.values()), 0)
        chunks = {s: np.frombuffer(b, np.uint8) for s, b in got.items()}
        dec = codec.decode(
            {shard}, chunks, len(next(iter(chunks.values())))
        )
        out = to_host(dec[shard]).tobytes()
        self.recovery_acct.record_repair(
            pg.pool_id, clabel, n_reads, read_bytes, len(out),
            full_gather=True)
        self._bg_stage("recovery_rebuild", t_rb0, trace_now(),
                       oid=oid, shard=shard)
        return out, size

    def _plan_repair_read(
        self, pg, codec, acting, oid: str, lost: int,
        exclude: set[int] | None, floor: int | None,
    ) -> tuple[bytes, int, int, int] | None:
        """Bandwidth-minimal rebuild of one lost EC shard following the
        codec's minimum_to_decode plan (reference: ECBackend asks the
        codec which chunks — and for CLAY which SUB-chunk ranges — a
        repair must read, instead of fetching every survivor).

        Returns (chunk_bytes, object_size, helper_reads, bytes_read) on
        success, or None to fall back to the broad-gather path.  The
        fast path bails on ANY surprise — a silent helper, a
        generation mismatch against this primary's chunk or the log
        floor, a sub-chunk geometry it cannot verify — because the
        fallback path owns stray hunting and mixed-generation
        arbitration; this path only claims the healthy common case,
        which is where the bandwidth goes (arXiv:1412.3022)."""
        my_shard = acting.index(self.id)
        if lost == my_shard:
            return None  # self-heal: no local generation/size anchor
        my_cid = self._cid(pg.pgid, my_shard)
        try:
            failpoint("osd.ec.shard_read", cct=self.cct,
                      entity=self.whoami, pgid=pg.pgid, shard=my_shard,
                      oid=oid)
            mine = bytes(self.store.read(my_cid, oid))
        except FailpointCrash:
            raise
        except (FailpointError, NotFound, KeyError):
            return None
        try:
            stored = int(self.store.getattr(my_cid, oid, "hinfo"))
        except (NotFound, KeyError, ValueError):
            stored = None
        if not mine or (stored is not None and crc32c(mine) != stored):
            return None
        my_ver = self._stored_ver(my_cid, oid)
        target = floor
        if my_ver is not None:
            if floor is not None and my_ver != floor:
                return None  # our own chunk is off-generation
            target = my_ver
        try:
            size = int(self.store.getattr(my_cid, oid, "size"))
        except (NotFound, KeyError, ValueError):
            return None
        avail = {
            s for s, o in enumerate(acting)
            if o >= 0 and s != lost and self.osdmap.is_up(o)
        } - (exclude or set())
        if my_shard not in avail:
            return None
        plan = None
        if bool(self.cct.conf.get("osd_repair_cost_aware")):
            # cost-aware helper choice (cephstorm; ROADMAP repair
            # residual): plan against the CHEAP subset first — helpers
            # whose piggybacked telemetry shows a deep mClock queue or
            # a degraded sentinel are pruned.  A codec that cannot plan
            # from the cheap subset (too few survivors) falls through
            # to the full availability set, so correctness never hinges
            # on telemetry.
            with self._lock:
                peer_load = dict(self._peer_load)
            cheap = prune_costly_helpers(
                avail, acting, my_shard, peer_load, time.monotonic(),
                float(self.cct.conf.get("osd_repair_telemetry_ttl")),
                int(self.cct.conf.get("osd_repair_helper_max_qlen")))
            if cheap != avail:
                try:
                    plan = codec.minimum_to_decode({lost}, cheap)
                except Exception:
                    plan = None
        if plan is None or lost in plan:
            try:
                plan = codec.minimum_to_decode({lost}, avail)
            except Exception:
                return None
        if lost in plan:
            return None  # plan wants the lost chunk itself: nonsense here
        helpers = sorted(plan)
        full_plan = all(
            len(r) == 1 and tuple(r[0]) == (0, -1)
            for r in plan.values()
        )
        if full_plan:
            return self._plan_full_reads(
                pg, codec, acting, oid, lost, helpers, mine, my_shard,
                my_ver, target, size)
        return self._plan_subchunk_reads(
            pg, codec, acting, oid, lost, plan, helpers, mine, my_shard,
            my_ver, target, size)

    def _plan_full_reads(self, pg, codec, acting, oid, lost, helpers,
                         mine, my_shard, my_ver, target, size):
        """MDS plan: exactly the k planned full chunks feed the decode
        — reads/repaired lands at the textbook k, not n-1.  The local
        chunk joins the decode only when the PLAN names it (the default
        MDS plan picks the k lowest available shards, which may not
        include this primary's own) — it still anchors chunk_size,
        generation, and object size either way."""
        vers: dict[int, int | None] = {my_shard: my_ver}
        got = self._gather_chunks(
            pg, codec, acting, oid, set(helpers) - {my_shard},
            vers=vers, stray=False)
        if my_shard in helpers:
            got[my_shard] = mine
        if set(got) != set(helpers):
            return None  # a planned helper went silent: fall back
        for v in vers.values():
            if v is not None and v != target:
                if target is None:
                    target = v
                else:
                    return None  # mixed generations: fall back
        if any(len(b) != len(mine) for b in got.values()):
            return None
        chunks = {s: np.frombuffer(bytes(b), np.uint8)
                  for s, b in got.items()}
        # the data conditions that send this rebuild to the broad gather
        # (a silent helper, mixed generations, a wrong size) returned
        # above; a failure of the decode itself — the GF apply's kernel
        # or the card — propagates and fails the rebuild (the recovery
        # tick logs and counts it), it never finishes on another path
        try:
            dec = codec.decode({lost}, chunks, len(mine))
        except InsufficientChunks:
            return None  # the plan's helpers cannot decode: broad gather
        out = to_host(dec[lost]).tobytes()
        nbytes = sum(len(b) for b in got.values())
        return out, size, len(got), nbytes

    def _plan_subchunk_reads(self, pg, codec, acting, oid, lost, plan,
                             helpers, mine, my_shard, my_ver, target,
                             size):
        """CLAY plan: fetch only the repair-plane sub-chunk ranges from
        each of the d helpers (ranged MECSubOpRead — hinfo-verified
        server-side) and rebuild through the codec's cached repair
        matrix: the live d/q-of-a-chunk repair bandwidth the bench
        measured offline, now on the recovery path."""
        if not hasattr(codec, "repair_matrix"):
            return None
        Z = codec.get_sub_chunk_count()
        chunk_size = len(mine)
        if Z <= 1 or chunk_size % Z:
            return None
        sub_len = chunk_size // Z
        nB = len(codec.repair_planes(lost))
        fetched: dict[int, np.ndarray] = {}
        bytes_read = 0
        for h in helpers:
            ranges = [tuple(r) for r in plan[h]]
            if ranges == [(0, -1)]:
                byte_ranges = [(0, chunk_size)]
            else:
                byte_ranges = [(off * sub_len, cnt * sub_len)
                               for off, cnt in ranges]
            want_len = sum(ln for _o, ln in byte_ranges)
            if h == my_shard:
                buf = b"".join(mine[o:o + ln] for o, ln in byte_ranges)
                ver = my_ver
            else:
                buf, ver = self._fetch_shard_ranges(
                    pg, acting, h, oid, byte_ranges)
            if buf is None or len(buf) != want_len:
                return None
            if ver is not None:
                if target is None:
                    target = ver
                elif ver != target:
                    return None  # stale-generation helper: fall back
            rows = np.frombuffer(buf, np.uint8).reshape(-1, sub_len)
            if rows.shape[0] not in (nB, Z):
                return None
            if rows.shape[0] == Z:
                # a full-chunk helper (want&avail merge case): slice
                # its repair planes for the stacked input
                rows = rows[np.asarray(codec.repair_planes(lost))]
            fetched[h] = rows
            bytes_read += want_len
        from ..ops import bitplane
        from ..ops.device_pool import POOL

        # cephdma: the cached repair matrix's stable digest keys the
        # device operand cache (no per-rebuild M.tobytes() host copy),
        # and the gathered helper sub-chunks commit to the OSD's device
        # through the stripe pool so repeated rebuilds of one geometry
        # recycle the same buffers.  The apply is not wrapped: a failed
        # kernel build or launch propagates and fails this rebuild (the
        # recovery tick logs and counts it) instead of finishing through
        # the broad-gather decode
        if hasattr(codec, "repair_matrix_entry"):
            M, m_key = codec.repair_matrix_entry(lost, tuple(helpers))
        else:
            M, m_key = codec.repair_matrix(lost, tuple(helpers)), None
        x = np.concatenate([fetched[h] for h in helpers])
        x_dev = POOL.put(x, self.device) if POOL.enabled() else x
        try:
            out = to_host(bitplane.apply_matrix(M, x_dev, device=self.device,
                                                mat_key=m_key))
        finally:
            # the pooled sub-chunk buffer comes back on success and on
            # failure alike, or every failed rebuild shrinks the pool
            if x_dev is not x:
                POOL.release(x_dev)
        chunk = out.reshape(Z * sub_len).tobytes()
        return chunk, size, len(helpers), bytes_read

    def _fetch_shard_ranges(self, pg, acting, shard: int, oid: str,
                            byte_ranges: list[tuple[int, int]]):
        """(concatenated bytes of `byte_ranges` from one shard's stored
        chunk, that shard's per-object version) via one multi-range
        MECSubOpRead; (None, None) on any failure.  The serving side
        verifies the WHOLE chunk's hinfo before slicing
        (subops._handle_sub_read), so rot cannot ride a ranged read."""
        osd = acting[shard] if shard < len(acting) else -1
        if osd < 0 or not self.osdmap.is_up(osd):
            return None, None
        tid = self._next_tid()
        try:
            self._conn_to_osd(osd).send_message(
                MECSubOpRead(
                    tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                    offsets=[[o, ln] for o, ln in byte_ranges],
                    epoch=self.my_epoch(),
                )
            )
        except (OSError, ConnectionError):
            return None, None
        rep = self._wait_reply(tid)
        if rep is None or rep.retval != 0:
            return None, None
        return unpack_data(rep.data), getattr(rep, "ver", None)
