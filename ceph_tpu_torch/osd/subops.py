"""Replica-side shard sub-op execution (reference: ECBackend::handle_sub_write/handle_sub_read).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations



import numpy as np

from ..common.crc32c import crc32c
from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.tracer import TRACER, TraceCtx
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpRead,
    MECSubOpReadReply,
    MECSubOpWrite,
    MECSubOpWriteReply,
    MPGClean,
    MPGNotify,
    MPGQuery,
    pack_data,
    unpack_data,
)
from .pg_log import LogEntry


class SubOpsMixin:
    # -- shard sub-ops -----------------------------------------------------
    def _load_fields(self) -> dict:
        """The `sender`/`qlen`/`degraded` kwargs every sub-op reply
        piggybacks (cephstorm): this OSD's id, its mClock queue depth,
        and the backend sentinel's degraded latch.  The primary's
        `_peer_load` map feeds cost-aware repair planning
        (`_plan_repair_read` skips loaded/degraded helpers)."""
        try:
            from ..common.kernel_telemetry import SENTINEL

            degraded = bool(SENTINEL.is_degraded)
        except Exception:
            degraded = False
        return {
            "sender": self.id,
            "qlen": self.scheduler.qlen(),
            "degraded": degraded,
        }

    def _handle_sub_write(self, conn, msg: MECSubOpWrite) -> None:
        pool_id, ps = msg.pgid.split(".")
        pg = self._pg(int(pool_id), int(ps))
        cid = self._cid(msg.pgid, msg.shard)
        retval = 0
        # cephtrace: the replica's commit joins the primary's subop span
        # across the daemon boundary (one attribute check when off)
        rspan = None
        if TRACER.enabled and getattr(msg, "trace_id", None) is not None:
            rspan = TRACER.begin(
                TraceCtx(msg.trace_id, msg.parent_span), "replica_commit",
                entity=self.whoami, shard=msg.shard, oid=msg.oid,
            )
        try:
            if (
                msg.epoch is not None
                and pg.interval_start
                and msg.epoch < pg.interval_start
            ):
                # sub-op from a PAST-interval primary (stale map racing
                # the change that re-elected this PG): refuse with the
                # DISTINCT -ESTALE code so the deposed sender knows to
                # step down rather than treat it as a flaky peer
                # (reference: ops tagged with an older
                # same_interval_since are dropped)
                TRACER.end(rspan, retval=-116)
                try:
                    conn.send_message(
                        MECSubOpWriteReply(tid=msg.tid, pgid=msg.pgid,
                                           shard=msg.shard, retval=-116,
                                           **self._load_fields())
                    )
                except (OSError, ConnectionError):
                    pass
                return
            with pg.lock:
                entry_op = msg.entry[1] if msg.entry else None
                t = Transaction()
                t.try_create_collection(cid)
                if (
                    msg.data is not None
                    and getattr(msg, "mode", None) in ("range", "delta")
                ):
                    # partial-stripe RMW sub-op: splice (data shard) or
                    # GF-XOR (parity shard) into the stored chunk.  The
                    # per-object version guard (`over` -> `ver`) is what
                    # makes this safe: an RMW onto a STALE generation
                    # would fuse old and new stripes, and a REPLAYED RMW
                    # (dup/resend) would double-apply the delta.
                    stored_ver = self._stored_ver(cid, msg.oid)
                    if stored_ver == msg.version:
                        # already applied (idempotent replay): ack as-is
                        pass
                    elif (
                        getattr(msg, "over", None) is None
                        or stored_ver != msg.over
                        or msg.version != pg.version + 1
                    ):
                        raise IOError(
                            f"rmw v{msg.over}->v{msg.version} onto shard "
                            f"at obj v{stored_ver} pg v{pg.version}"
                        )
                    else:
                        seg = unpack_data(msg.data)
                        if crc32c(seg) != msg.crc:
                            raise IOError("rmw sub-op crc mismatch")
                        off = int(msg.off or 0)
                        try:
                            full = bytearray(self.store.read(cid, msg.oid))
                        except (NotFound, KeyError):
                            raise IOError("rmw target chunk missing on shard")
                        if off + len(seg) > len(full):
                            raise IOError("rmw beyond stored chunk")
                        # rot check BEFORE applying: stamping a fresh
                        # hinfo over a corrupt base would launder the rot
                        # past every later integrity check
                        try:
                            stored_h = int(
                                self.store.getattr(cid, msg.oid, "hinfo"))
                        except (NotFound, KeyError, ValueError):
                            stored_h = None
                        if (stored_h is not None
                                and crc32c(bytes(full)) != stored_h):
                            raise IOError("rmw base chunk failed hinfo")
                        if msg.mode == "delta":
                            seg = (
                                np.frombuffer(
                                    bytes(full[off:off + len(seg)]), np.uint8
                                )
                                ^ np.frombuffer(seg, np.uint8)
                            ).tobytes()
                        full[off:off + len(seg)] = seg
                        t.write(cid, msg.oid, off, seg)
                        t.setattr(cid, msg.oid, "hinfo",
                                  str(crc32c(bytes(full))).encode())
                        t.setattr(cid, msg.oid, "ver",
                                  str(msg.version).encode())
                        if msg.osize is not None:
                            t.setattr(cid, msg.oid, "size",
                                      str(msg.osize).encode())
                elif msg.data is not None:
                    chunk = unpack_data(msg.data)
                    if crc32c(chunk) != msg.crc:
                        raise IOError("chunk crc mismatch")
                    # generation-regression guard: a full-chunk push
                    # rebuilt from STALE sources (a donor that hasn't
                    # caught up across an acting permutation) must never
                    # overwrite a NEWER generation we hold — that is how
                    # an applied write gets rolled back cluster-wide.
                    # Equal/newer stamps apply (idempotent refresh /
                    # catch-up); wildcard pushes only land on chunks
                    # that carry no numeric stamp themselves.
                    stored_gen = self._stored_ver(cid, msg.oid)
                    push_gen = getattr(msg, "over", None)
                    if push_gen is None:
                        push_gen = msg.version
                    if stored_gen is not None and (
                        push_gen is None or push_gen < stored_gen
                    ):
                        raise IOError(
                            f"refusing generation regression "
                            f"v{push_gen} onto v{stored_gen}"
                        )
                    t.write(cid, msg.oid, 0, chunk)
                    t.truncate(cid, msg.oid, len(chunk))
                    t.setattr(cid, msg.oid, "hinfo", str(msg.crc).encode())
                    # full-chunk pushes stamp the chunk GENERATION: a
                    # recovery push carries the primary's stored stamp
                    # (`over`) since its bytes are rebuilt-current; a
                    # live write stamps its own version; a push that
                    # knows neither (backfill of a legacy object) stamps
                    # the wildcard so readers accept the bytes
                    gen = getattr(msg, "over", None)
                    if gen is None:
                        gen = msg.version
                    t.setattr(cid, msg.oid, "ver",
                              str(gen).encode() if gen else b"")
                    if msg.osize is not None:
                        t.setattr(cid, msg.oid, "size",
                                  str(msg.osize).encode())
                elif (
                    entry_op == "modify"
                    and msg.osize is not None
                    and msg.xattrs is None
                ):
                    # entry-only RMW companion (this shard's chunk bytes
                    # were untouched): keep the size xattr and object
                    # version current, but only if we actually hold the
                    # object — and only when our log is contiguous, else
                    # we'd stamp a version whose writes we missed.
                    # (`ver` is a CHUNK-GENERATION stamp: xattr-only
                    # pushes carry msg.xattrs and must not touch it —
                    # they don't change stripe bytes)
                    if msg.version is not None and msg.version == pg.version + 1:
                        try:
                            self.store.stat(cid, msg.oid)
                        except (NotFound, KeyError):
                            pass
                        else:
                            t.setattr(cid, msg.oid, "size",
                                      str(msg.osize).encode())
                            t.setattr(cid, msg.oid, "ver",
                                      str(msg.version).encode())
                elif entry_op in (None, "delete") and not msg.xattrs:
                    # data-less delete (live op or recovery replay)
                    try:
                        self.store.stat(cid, msg.oid)
                        t.remove(cid, msg.oid)
                    except (NotFound, KeyError):
                        pass
                # else: entry-only push ("modify" log replay / "clean"
                # seal / xattr-only update) — no data op
                if msg.xattrs is not None:
                    if msg.data is not None:
                        # riding a data push (recovery): the dict is a FULL
                        # snapshot — stale attrs a removal we missed must
                        # not survive
                        self._apply_xattr_updates(
                            t, cid, msg.oid, msg.xattrs, snapshot=True
                        )
                    else:
                        # live xattr-only update: apply ONLY if this shard
                        # holds the object; a shard that missed the write
                        # must not grow a phantom zero-length object
                        # (recovery pushes data + attrs together later)
                        try:
                            self.store.stat(cid, msg.oid)
                        except (NotFound, KeyError):
                            pass
                        else:
                            self._apply_xattr_updates(
                                t, cid, msg.oid, msg.xattrs
                            )
                if getattr(msg, "rmattrs", None):
                    # atomic-with-data attr removals (cache-tier clean
                    # clear riding a mutation); only if we hold the object
                    try:
                        existing = set(self.store.getattrs(cid, msg.oid))
                    except (NotFound, KeyError):
                        existing = set()
                    for name in msg.rmattrs:
                        if f"u_{name}" in existing:
                            t.rmattr(cid, msg.oid, f"u_{name}")
                if getattr(msg, "omap", None) is not None:
                    # live omap mutation or recovery snapshot: omap
                    # exists on replicated pools only; an omap op on a
                    # fresh oid creates the object (touch), matching the
                    # primary's transaction
                    t.touch(cid, msg.oid)
                    self._apply_omap(t, cid, msg.oid, msg.omap)
                    if (msg.data is None and msg.version is not None
                            and msg.version == pg.version + 1):
                        # live omap-only update on a log-contiguous
                        # shard: stamp the version for dup verification
                        t.setattr(cid, msg.oid, "ver",
                                  str(msg.version).encode())
                if (
                    msg.entry is not None
                    and msg.version is not None
                    and msg.version > pg.version
                ):
                    if entry_op == "clean":
                        # a clean that JUMPS our version means we were
                        # backfilled across a gap: seal an empty log window
                        # so covers() stays honest about what we can vouch
                        # for entry-by-entry
                        self._log_seal_txn(t, cid, pg, msg.version)
                    elif msg.version == pg.version + 1:
                        entry = LogEntry.from_list(msg.entry)
                        self._log_txn(t, cid, pg, entry)
                    # else: the entry JUMPS our version (we missed writes —
                    # e.g. a sub-write lost while the primary acked at
                    # min_size).  Apply the data but refuse the log append:
                    # advancing head across a hole would make this shard
                    # report itself clean at a version whose intermediate
                    # objects it does not hold.  Our stale version makes
                    # the primary's next recovery tick replay the gap.
                self.store.queue_transaction(t)
                # cephread belt-and-braces: a replica apply supersedes
                # any object this daemon cached while IT was primary (a
                # flapped-back primary's stale entry would otherwise
                # survive until version validation catches it)
                self._read_cache_invalidate(msg.pgid, msg.oid)
        except Exception as e:
            self.cct.dout("osd", 0, f"{self.whoami} sub_write failed: {e!r}")
            retval = -5
        else:
            self.logger.inc("subop_w")
        TRACER.end(rspan, retval=retval)
        try:
            conn.send_message(
                MECSubOpWriteReply(tid=msg.tid, pgid=msg.pgid,
                                   shard=msg.shard, retval=retval,
                                   **self._load_fields())
            )
        except (OSError, ConnectionError):
            pass

    def _handle_sub_read(self, conn, msg: MECSubOpRead) -> None:
        cid = self._cid(msg.pgid, msg.shard)
        if getattr(msg, "reads", None):
            self._handle_sub_read_multi(conn, msg, cid)
            return
        try:
            # "osd.ec.shard_read" (legacy: osd_debug_inject_read_err) —
            # an error action makes this shard answer EIO, forcing the
            # primary onto the reconstruct-from-survivors path
            failpoint("osd.ec.shard_read", cct=self.cct,
                      entity=self.whoami, pgid=msg.pgid, shard=msg.shard,
                      oid=msg.oid)
        except FailpointCrash:
            raise
        except FailpointError:
            try:
                conn.send_message(MECSubOpReadReply(
                    tid=msg.tid, pgid=msg.pgid, oid=msg.oid,
                    shard=msg.shard, retval=-5, data=None, size=None,
                    xattrs=None, ver=None, **self._load_fields(),
                ))
            except (OSError, ConnectionError):
                pass
            return
        try:
            if msg.offsets == []:
                # metadata-only probe: existence + size/xattrs, no body
                self.store.stat(cid, msg.oid)
                data = b""
            elif msg.offsets:
                # ranged reads feed RMW old-byte fetches and CLAY repair:
                # verify the WHOLE chunk's hinfo first — serving rotted
                # bytes here would poison a parity delta with a fresh CRC
                # stamped over it (no rot check could catch it later)
                whole = self.store.read(cid, msg.oid)
                try:
                    stored = int(self.store.getattr(cid, msg.oid, "hinfo"))
                except (NotFound, KeyError, ValueError):
                    stored = None
                if stored is not None and crc32c(whole) != stored:
                    self.cct.dout(
                        "osd", 0,
                        f"{self.whoami} hinfo mismatch on ranged read "
                        f"{msg.pgid}/{msg.oid} shard {msg.shard}",
                    )
                    raise NotFound(msg.oid)
                parts = []
                for off, ln in msg.offsets:
                    if ln == -1:
                        parts.append(whole)
                    else:
                        parts.append(whole[off:off + ln])
                data = b"".join(parts)
            else:
                data = self.store.read(cid, msg.oid)
                # full-chunk read: verify at-rest integrity against the
                # stored hinfo CRC before serving — a rotted chunk must
                # read as MISSING so the primary reconstructs instead of
                # decoding garbage (reference: ECBackend checks
                # ECUtil::HashInfo on read, -EIO on mismatch)
                try:
                    stored = int(self.store.getattr(cid, msg.oid, "hinfo"))
                except (NotFound, KeyError, ValueError):
                    stored = None
                if stored is not None and crc32c(data) != stored:
                    self.cct.dout(
                        "osd", 0,
                        f"{self.whoami} hinfo mismatch on read "
                        f"{msg.pgid}/{msg.oid} shard {msg.shard}",
                    )
                    raise NotFound(msg.oid)
            try:
                size = int(self.store.getattr(cid, msg.oid, "size"))
            except (NotFound, KeyError):
                size = None
            try:
                user = {
                    n[2:]: pack_data(v)
                    for n, v in self.store.getattrs(cid, msg.oid).items()
                    if n.startswith("u_")
                }
            except (NotFound, KeyError):
                user = None
            reply = MECSubOpReadReply(
                tid=msg.tid, pgid=msg.pgid, oid=msg.oid, shard=msg.shard,
                retval=0, data=pack_data(data), size=size, xattrs=user,
                ver=self._stored_ver(cid, msg.oid),
                **self._load_fields(),
            )
        except (NotFound, KeyError):
            reply = MECSubOpReadReply(
                tid=msg.tid, pgid=msg.pgid, oid=msg.oid, shard=msg.shard,
                retval=-2, data=None, size=None, xattrs=None, ver=None,
                **self._load_fields(),
            )
        try:
            conn.send_message(reply)
        except (OSError, ConnectionError):
            pass

    def _handle_sub_read_multi(self, conn, msg: MECSubOpRead, cid) -> None:
        """cephread batched branch: serve a `reads=[[oid, off, ln], ...]`
        list in one reply (the read batcher's one fan-out per flush).
        Per-entry semantics match the single-oid path exactly — the
        `osd.ec.shard_read` failpoint fires once per entry (so a
        thrasher `times(n,error)` spec EIOs n entries, not n batches),
        the WHOLE chunk's hinfo CRC is verified before any slice is
        served, and a missing/rotted entry answers its own -2/-5 row
        without failing siblings."""
        rows = []
        for ent in msg.reads:
            oid, off, ln = ent[0], ent[1], ent[2]
            try:
                failpoint("osd.ec.shard_read", cct=self.cct,
                          entity=self.whoami, pgid=msg.pgid,
                          shard=msg.shard, oid=oid)
            except FailpointCrash:
                raise
            except FailpointError:
                rows.append([-5, None, None, None])
                continue
            try:
                whole = self.store.read(cid, oid)
                try:
                    stored = int(self.store.getattr(cid, oid, "hinfo"))
                except (NotFound, KeyError, ValueError):
                    stored = None
                if stored is not None and crc32c(whole) != stored:
                    self.cct.dout(
                        "osd", 0,
                        f"{self.whoami} hinfo mismatch on batched read "
                        f"{msg.pgid}/{oid} shard {msg.shard}",
                    )
                    raise NotFound(oid)
                data = whole if off is None else whole[off:off + ln]
                try:
                    size = int(self.store.getattr(cid, oid, "size"))
                except (NotFound, KeyError):
                    size = None
                rows.append([0, pack_data(data), size,
                             self._stored_ver(cid, oid)])
            except (NotFound, KeyError):
                rows.append([-2, None, None, None])
        try:
            conn.send_message(MECSubOpReadReply(
                tid=msg.tid, pgid=msg.pgid, oid=None, shard=msg.shard,
                retval=0, data=None, size=None, xattrs=None, ver=None,
                results=rows, **self._load_fields(),
            ))
        except (OSError, ConnectionError):
            pass

    def _handle_pg_query(self, conn, msg: MPGQuery) -> None:
        pool_id, ps = msg.pgid.split(".")
        pg = self._pg(int(pool_id), int(ps))
        cid = self._cid(msg.pgid, msg.shard)
        oids = []
        try:
            oids = sorted(
                o for o in self.store.list_objects(cid)
                if not o.startswith("_")
            )
        except (NotFound, KeyError):
            pass
        try:
            conn.send_message(
                MPGNotify(tid=msg.tid, pgid=msg.pgid, shard=msg.shard,
                          version=pg.version, log_start=pg.log.tail,
                          oids=oids, last_epoch=pg.last_map_epoch)
            )
        except (OSError, ConnectionError):
            pass

    def _handle_pg_clean(self, msg: MPGClean) -> None:
        """Primary says the PG went clean at `epoch` (the
        last_epoch_clean role): advance the persisted rebuild floor and
        drop local interval history — settled intervals must never
        re-block a future peering round.  A clean claim from a PAST
        interval is ignored (a deposed primary cannot retro-settle
        history it no longer owns)."""
        pool_id, ps = msg.pgid.split(".")
        pg = self._pg(int(pool_id), int(ps))
        with pg.lock:
            if msg.epoch < pg.interval_start:
                return
            pg.last_map_epoch = max(pg.last_map_epoch, int(msg.epoch))
            pg.past_intervals.clear()
            pg.intervals_rebuilt = False
            self._save_intervals(pg)

