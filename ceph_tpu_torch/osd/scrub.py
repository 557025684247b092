"""Scrub orchestration and shard digests (reference: src/osd/scrubber, deep-scrub subset).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations




from ..common.crc32c import crc32c
from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.tracer import TRACER, op_trace, set_op_trace, trace_now
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpRead,
    MScrubShard,
    MScrubShardReply,
    unpack_data,
)
from ..osd.osdmap import PG_POOL_ERASURE


class ScrubMixin:
    # -- scrub (reference: src/osd/scrubber — deep scrub subset) ----------
    def _local_scrub_map(self, cid: str) -> dict:
        """ScrubMap of one shard collection: oid -> [computed_crc,
        stored_crc_or_None, size] (reference: PGBackend::be_scan_list)."""
        objects: dict[str, list] = {}
        try:
            oids = self.store.list_objects(cid)
        except (NotFound, KeyError):
            return objects
        for oid in oids:
            if oid.startswith("_"):
                continue
            try:
                data = self.store.read(cid, oid)
            except (NotFound, KeyError):
                continue
            try:
                stored = int(self.store.getattr(cid, oid, "hinfo"))
            except (NotFound, KeyError, ValueError):
                stored = None
            objects[oid] = [crc32c(data), stored, len(data)]
        return objects

    def _replicated_authoritative(
        self, pg, maps: dict, acting: list[int], oid: str, bad_shard: int
    ) -> tuple[bytes | None, int]:
        """Authoritative copy for a replicated repair: any replica whose
        scrub entry is self-consistent (computed == stored digest), the
        primary's preferred (reference: be_select_auth_object)."""
        candidates = sorted(
            maps,
            key=lambda s: (acting[s] != self.id, s),  # self first
        )
        for s in candidates:
            if s == bad_shard:
                continue
            ent = maps[s].get(oid)
            if ent is None or (ent[1] is not None and ent[0] != ent[1]):
                continue
            osd = acting[s]
            if osd == self.id:
                try:
                    data = self.store.read(self._cid(pg.pgid, 0), oid)
                    return bytes(data), len(data)
                except (NotFound, KeyError):
                    continue
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpRead(tid=tid, pgid=pg.pgid, oid=oid, shard=0,
                                 offsets=None, epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid, timeout=5.0)
            if rep is not None and rep.retval == 0:
                data = unpack_data(rep.data)
                return data, len(data)
        return None, 0

    def _handle_scrub_shard(self, conn, msg: MScrubShard) -> None:
        try:
            # "osd.scrub.shard": an error action makes this shard go
            # silent — the primary scrubs with the maps it can gather
            failpoint("osd.scrub.shard", cct=self.cct,
                      entity=self.whoami, pgid=msg.pgid, shard=msg.shard)
        except FailpointCrash:
            raise
        except FailpointError:
            return
        try:
            conn.send_message(
                MScrubShardReply(
                    tid=msg.tid, pgid=msg.pgid, shard=msg.shard,
                    objects=self._local_scrub_map(
                        self._cid(msg.pgid, msg.shard)
                    ),
                )
            )
        except (OSError, ConnectionError):
            pass

    def scrub_pg(self, pool_id: int, ps: int, repair: bool = True) -> dict:
        """cephheal wrapper around _scrub_pg_inner: one scrub = one
        traceable, TrackedOp-registered background op (src="scrub"),
        with the same head-coin-flip + tail-provisional trace contract
        client ops get — a slow scrub keeps its tree at sampling=0 and
        shows up in dump_historic_slow_ops."""
        # "osd.scrub.start": error aborts the scrub before any shard map
        # is collected; delay stretches the scrub window
        failpoint("osd.scrub.start", cct=self.cct, entity=self.whoami,
                  pgid=f"{pool_id}.{ps}")
        ctx = self._bg_trace_ctx()
        root = None
        if ctx is not None:
            root = TRACER.begin(ctx, "scrub", entity=self.whoami,
                                pgid=f"{pool_id}.{ps}", repair=repair)
        tracked = self.op_tracker.create(
            f"scrub({pool_id}.{ps})", src="scrub")
        tracked.trace_id = ctx.trace_id if ctx is not None else None
        # save/restore the op-trace state: a scrub driven through the
        # client `scrub` op runs on an op thread that already carries
        # the client op's state
        prev = op_trace()
        set_op_trace({
            "ctx": root.ctx() if root is not None else ctx,
            "tracked": tracked,
        })
        try:
            result = self._scrub_pg_inner(pool_id, ps, repair)
            TRACER.end(root, errors=len(result.get("errors") or ()),
                       repaired=result.get("repaired", 0))
            root = None
            return result
        finally:
            set_op_trace(prev)
            TRACER.end(root)  # error path: close unconditionally
            tracked.finish()
            if TRACER.enabled and tracked.trace_id is not None:
                self._bg_tail_verdict(tracked)

    def _scrub_pg_inner(self, pool_id: int, ps: int,
                        repair: bool = True) -> dict:
        """Deep scrub one PG from its primary: collect every shard's
        ScrubMap, flag shards whose at-rest bytes rotted under their own
        digest or that miss objects others hold, and (repair=True) rebuild
        those shards from the surviving ones (reference:
        PrimaryLogPG::scrub_compare_maps + repair_object)."""
        m = self.osdmap
        pool = m.pools.get(pool_id) if m else None
        if pool is None:
            raise KeyError(f"no pool {pool_id}")
        acting, primary = self._acting(pool_id, ps)
        if primary != self.id:
            raise RuntimeError(f"not primary for {pool_id}.{ps}")
        pg = self._pg(pool_id, ps)
        is_ec = pool.type == PG_POOL_ERASURE
        codec = self._codec_for_pool(pool) if is_ec else None
        # map collection runs UNLOCKED (writes proceed; a racing write can
        # only produce a false positive whose "repair" re-pushes current,
        # consistent bytes).  pg.lock is taken per-object for repairs, so
        # a slow shard never blocks client I/O for the whole scrub.
        t_read0 = trace_now()
        maps: dict[int, dict] = {}
        tids: dict[int, int] = {}
        for shard, osd in enumerate(acting):
            store_shard = shard if is_ec else 0
            if osd < 0 or not m.is_up(osd):
                continue
            if osd == self.id:
                maps[shard] = self._local_scrub_map(
                    self._cid(pg.pgid, store_shard)
                )
                continue
            tid = self._next_tid()
            tids[tid] = shard
            try:
                self._conn_to_osd(osd).send_message(
                    MScrubShard(tid=tid, pgid=pg.pgid, shard=store_shard,
                                epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                tids.pop(tid, None)
        for tid, shard in tids.items():
            rep = self._wait_reply(tid, timeout=10.0)
            if rep is not None:
                maps[shard] = rep.objects or {}
        self._bg_stage("scrub_read", t_read0, trace_now(),
                       shards=len(maps))

        t_cmp0 = trace_now()
        all_oids: set[str] = set()
        for sm in maps.values():
            all_oids |= set(sm)
        # objects whose FINAL log entry is a delete: a shard still holding
        # one is stale (its delete sub-op was lost) — flag the holder, and
        # never let "missing" on up-to-date shards resurrect the object
        _newest, log_deleted = pg.log.missing_since(0)
        my_shard = next((s for s in maps if acting[s] == self.id), None)
        errors: list[dict] = []
        for oid in sorted(all_oids):
            if oid in log_deleted:
                for shard, sm in maps.items():
                    if oid in sm:
                        errors.append(
                            {"oid": oid, "shard": shard,
                             "error": "stale_deleted"}
                        )
                continue
            # authoritative digest for cross-copy comparison (replicated):
            # a SELF-CONSISTENT copy, the primary's preferred (reference:
            # be_select_auth_object) — never a copy that fails its own
            # digest, so primary bit-rot cannot propagate
            auth_crc = None
            if not is_ec:
                order = sorted(
                    maps, key=lambda s: (s != my_shard, s)
                )
                for s in order:
                    ent = maps[s].get(oid)
                    if ent is None:
                        continue
                    if ent[1] is None or ent[0] == ent[1]:
                        auth_crc = ent[0]
                        break
            for shard, sm in maps.items():
                ent = sm.get(oid)
                if ent is None:
                    errors.append(
                        {"oid": oid, "shard": shard, "error": "missing"}
                    )
                elif ent[1] is not None and ent[0] != ent[1]:
                    # at-rest rot under the shard's own digest (EC chunks
                    # and, with hinfo now stamped everywhere, replicas)
                    errors.append(
                        {"oid": oid, "shard": shard,
                         "error": "data_digest_mismatch"}
                    )
                elif (
                    not is_ec
                    and auth_crc is not None
                    and ent[0] != auth_crc
                ):
                    errors.append(
                        {"oid": oid, "shard": shard,
                         "error": "data_digest_mismatch"}
                    )
            self.logger.inc("scrubs")
            self.logger.inc("scrub_errors", len(errors))
        self._bg_stage("scrub_compare", t_cmp0, trace_now(),
                       objects=len(all_oids), errors=len(errors))
        repaired = 0
        if repair and errors:
            t_rep0 = trace_now()
            # shards known-bad per oid: their chunks must not feed a
            # rebuild (decoding from a rotted chunk would launder the
            # corruption into a fresh self-consistent digest)
            bad_by_oid: dict[str, set[int]] = {}
            for err in errors:
                bad_by_oid.setdefault(err["oid"], set()).add(err["shard"])
            for err in errors:
                shard = err["shard"]
                osd = acting[shard]
                store_shard = shard if is_ec else 0
                with pg.lock:  # per-object: writes proceed between repairs
                    if err["error"] == "stale_deleted":
                        if osd == self.id:
                            cid = self._cid(pg.pgid, store_shard)
                            t = Transaction()
                            try:
                                self.store.stat(cid, err["oid"])
                                t.remove(cid, err["oid"])
                                self.store.queue_transaction(t)
                                repaired += 1
                            except (NotFound, KeyError):
                                pass
                        elif self._push_sub_write(
                            pg, osd, store_shard, err["oid"], None, None,
                            None,
                        ):
                            repaired += 1
                        continue
                    if is_ec:
                        chunk, size = self._rebuild_shard_chunk(
                            pg, codec, acting, err["oid"], shard, True,
                            exclude=bad_by_oid.get(err["oid"], set()),
                        )
                    else:
                        chunk, size = self._replicated_authoritative(
                            pg, maps, acting, err["oid"], bad_shard=shard
                        )
                    if chunk is None:
                        continue
                    if osd == self.id:
                        cid = self._cid(pg.pgid, store_shard)
                        t = Transaction()
                        t.try_create_collection(cid)
                        t.write(cid, err["oid"], 0, chunk)
                        t.truncate(cid, err["oid"], len(chunk))
                        t.setattr(cid, err["oid"], "hinfo",
                                  str(crc32c(chunk)).encode())
                        t.setattr(cid, err["oid"], "size",
                                  str(size).encode())
                        self.store.queue_transaction(t)
                        repaired += 1
                    elif self._push_sub_write(
                        pg, osd, store_shard, err["oid"], chunk, None,
                        [0, "modify", err["oid"]], osize=size,
                        src_cid=self._cid(
                            pg.pgid,
                            acting.index(self.id) if is_ec else 0),
                    ):
                        repaired += 1
            self.logger.inc("scrub_repairs", repaired)
            self._bg_stage("scrub_repair", t_rep0, trace_now(),
                           repaired=repaired, errors=len(errors))
        return {
            "pgid": pg.pgid,
            "shards": len(maps),
            "objects": len(all_oids),
            "errors": errors,
            "repaired": repaired if repair else 0,
        }

