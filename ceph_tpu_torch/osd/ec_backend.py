"""EC writes, reads-with-reconstruct, and partial-stripe RMW parity deltas (reference: src/osd/ECBackend.cc, src/osd/ECTransaction.cc).

Split out of osd/daemon.py (round-4 verdict item #6) — the methods
are verbatim; `OSD` composes every mixin, so cross-mixin calls (e.g.
the tier front-end invoking the replicated backend) resolve on self.
"""
from __future__ import annotations



import time

import numpy as np

from ..common.crc32c import crc32c
from ..common.device import to_host
from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.tracer import TRACER, op_trace, trace_now
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpRead,
    MECSubOpWrite,
    MOSDOp,
    MOSDOpReply,
    pack_data,
    unpack_data,
)
from .pg import CLONE_SEP, PGState, _current_generation
from .pg_log import LogEntry


class ECBackendMixin:
    # .. coalesced encode (osd/write_batcher.py) ...........................
    def _batch_matrix(self, codec):
        """(coding matrix, stable digest) IF the codec's encode is a
        plain byte-column-local GF matrix apply with identity chunk
        placement — the property (same one the RMW parity delta rests
        on) under which stripes from DIFFERENT ops can be fused along
        the column axis and encoded in one batch.  (None, None) = not
        batchable: sub-chunked (CLAY), packet/bitmatrix, remapped (LRC)
        codecs, and the numpy referee backend, all encode inline.

        The digest (ops.bitplane.matrix_digest) is computed ONCE and
        cached on the codec object — the batcher and the device
        bitmatrix cache key by it instead of a fresh per-stripe
        ``mat.tobytes()`` host copy (the cephdma satellite fix)."""
        if getattr(codec, "backend", "torch") != "torch":
            # the numpy referee backend keeps its own encode path
            # (parity provenance for the cross-backend equality tests);
            # plugins without the attr (shec, clay) run on the device
            return None, None
        try:
            if not codec.supports_parity_delta():
                return None, None
            if codec.get_sub_chunk_count() != 1:
                return None, None
        except (AttributeError, NotImplementedError):
            return None, None
        mat = getattr(codec, "coding", None)
        if not isinstance(mat, np.ndarray):
            return None, None
        key = getattr(codec, "_coding_digest", None)
        if key is None:
            from ..ops.bitplane import matrix_digest

            key = matrix_digest(mat)
            try:
                codec._coding_digest = key
            except (AttributeError, TypeError):
                pass  # frozen codec object: recompute per call
        return mat, key

    def _ec_encode_chunks(self, codec, chunks):
        """encode_chunks through the write batcher when eligible
        (coalesced with concurrent ops' stripes), codec-inline
        otherwise; parity bytes identical either way."""
        batcher = getattr(self, "write_batcher", None)
        mat, mat_key = self._batch_matrix(codec)
        if batcher is None or mat is None:
            t0 = trace_now()
            out = to_host(codec.encode_chunks(chunks))
            self._op_stage("encode", t0, trace_now(), codec_inline=True)
            return out
        return batcher.encode_chunks(mat, chunks, mat_key=mat_key)

    def _ec_encode(self, codec, data: bytes) -> dict:
        """Full-stripe encode for _ec_write: same chunk dict as
        ``codec.encode(set(range(n)), data)``, with the parity matmul
        routed through the write batcher when the codec is batchable."""
        n = codec.get_chunk_count()
        batcher = getattr(self, "write_batcher", None)
        mat, mat_key = self._batch_matrix(codec)
        if batcher is None or mat is None:
            t0 = trace_now()
            enc = {i: to_host(c)
                   for i, c in codec.encode(set(range(n)), data).items()}
            self._op_stage("encode", t0, trace_now(), codec_inline=True)
            return enc
        k = codec.get_data_chunk_count()
        L = codec.get_chunk_size(len(data))
        chunks = codec.encode_prepare(data, L)
        parity = batcher.encode_chunks(mat, chunks, mat_key=mat_key)
        enc = {i: chunks[i] for i in range(k)}
        for j in range(parity.shape[0]):
            enc[k + j] = parity[j]
        return enc

    # .. EC pool ...........................................................
    def _ec_op(self, pg: PGState, pool, acting: list[int], msg: MOSDOp):
        codec = self._codec_for_pool(pool)
        my_shard = acting.index(self.id)
        if msg.op in ("write_full", "write", "append", "delete"):
            # min_size gate BEFORE any mutation (reference: PrimaryLogPG
            # refuses ops while acting < pool.min_size): refusing up front
            # both protects durability (never take a write we may not be
            # able to re-protect) and keeps -EAGAIN retries side-effect
            # free — a partially-applied-then-refused write would make
            # the client resend double-apply
            reachable = sum(
                1 for o in acting
                if o >= 0 and (o == self.id or self.osdmap.is_up(o))
            )
            if reachable < pool.min_size:
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result=f"{reachable} acting shards reachable < "
                           f"min_size {pool.min_size}",
                )
        if msg.op == "write_full":
            data = unpack_data(msg.data) or b""
            with pg.lock:
                return self._ec_write(
                    pg, pool, codec, acting, my_shard, msg, data
                )
        if msg.op in ("write", "append"):
            data = unpack_data(msg.data) or b""
            with pg.lock:
                return self._ec_rmw(
                    pg, pool, codec, acting, my_shard, msg, data
                )
        if msg.op == "read":
            return self._ec_read(pg, codec, acting, msg)
        if msg.op == "delete":
            with pg.lock:
                return self._ec_delete(pg, acting, my_shard, msg)
        if msg.op == "stat":
            try:
                size = int(
                    self.store.getattr(
                        self._cid(pg.pgid, my_shard), msg.oid, "size"
                    )
                )
                return MOSDOpReply(tid=msg.tid, retval=0,
                                   epoch=self.my_epoch(),
                                   result={"size": size, "version": pg.version})
            except (NotFound, KeyError):
                return MOSDOpReply(tid=msg.tid, retval=-2,
                                   epoch=self.my_epoch(), result="not found")
        if msg.op == "list":
            oids = sorted(
                o for o in self.store.list_objects(self._cid(pg.pgid, my_shard))
                if not o.startswith("_") and CLONE_SEP not in o
            )
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"oids": oids})
        if msg.op in ("setxattr", "getxattrs"):
            return self._xattr_op(pg, acting, my_shard, msg)
        if msg.op.startswith("omap_") or msg.op == "exec":
            # reference parity: EC pools support neither omap nor the
            # omap-backed object classes
            # (PrimaryLogPG::do_osd_ops returns -EOPNOTSUPP)
            return MOSDOpReply(tid=msg.tid, retval=-95,
                               epoch=self.my_epoch(),
                               result=f"{msg.op} not supported on EC pools")
        if msg.op in ("watch", "unwatch", "notify"):
            return self._watch_op(pg, pool, msg)
        return MOSDOpReply(tid=msg.tid, retval=-22, epoch=self.my_epoch(),
                           result=f"bad op {msg.op}")

    # .. partial-stripe RMW ................................................
    def _ec_object_size(self, pg, acting, oid: str):
        """Stored object size (the `size` xattr), local shard preferred,
        else reachable peers' metadata probes.  Returns an int, "absent"
        (a shard DEFINITIVELY reported no such object), or "unknown"
        (nobody answered either way — e.g. transient connection faults).
        The distinction matters: treating unreachable as absent would
        let a ranged write re-create an existing object as zeros."""
        for shard, osd in enumerate(acting):
            if osd != self.id:
                continue
            try:
                return int(self.store.getattr(
                    self._cid(pg.pgid, shard), oid, "size"))
            except (NotFound, KeyError, ValueError):
                break
        verdict = "unknown"
        best_size = None
        best_ver = -1
        for shard, osd in enumerate(acting):
            if osd < 0 or osd == self.id or not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpRead(tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                                 offsets=[], epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                continue
            rep = self._wait_reply(tid)
            if rep is None:
                continue
            if rep.retval == 0 and rep.size is not None:
                # prefer the NEWEST-generation shard's size: a stale
                # shard that missed the last append would hand back the
                # old size and the append would overwrite live bytes
                v = getattr(rep, "ver", None)
                if v is None:
                    v = 0
                if v > best_ver or best_size is None:
                    best_ver, best_size = v, int(rep.size)
            elif rep.retval == -2:
                verdict = "absent"  # a live shard is sure it isn't there
        if best_size is not None:
            return best_size
        return verdict

    def _fetch_shard_range(self, pg, acting, shard: int, oid: str,
                           off: int, ln: int):
        """(`ln` bytes at `off` of one shard's stored chunk, that shard's
        stored per-object version) — local or via a ranged MECSubOpRead.
        (None, None) = holder down / chunk missing / short read."""
        osd = acting[shard] if shard < len(acting) else -1
        if osd == self.id:
            cid = self._cid(pg.pgid, shard)
            try:
                b = self.store.read(cid, oid, off, ln)
            except (NotFound, KeyError):
                return None, None
            return (bytes(b), self._stored_ver(cid, oid)) \
                if len(b) == ln else (None, None)
        if osd < 0 or not self.osdmap.is_up(osd):
            return None, None
        tid = self._next_tid()
        try:
            self._conn_to_osd(osd).send_message(
                MECSubOpRead(tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                             offsets=[[off, ln]], epoch=self.my_epoch())
            )
        except (OSError, ConnectionError):
            return None, None
        rep = self._wait_reply(tid)
        if rep is None or rep.retval != 0:
            return None, None
        b = unpack_data(rep.data) or b""
        return (b, rep.ver) if len(b) == ln else (None, None)

    def _rb_fetch_ranges(self, pg, acting, my_shard: int, oid: str,
                         wants: list[tuple[int, int, int]]):
        """Coalesced `_fetch_shard_range` for many shards at once:
        {shard: (bytes, ver) | (None, None)} via one read-batcher
        gather, or None when the batcher is absent/not coalescing/
        failed (caller falls back to the per-shard path).  Same
        contract as `_fetch_shard_range`: a short or missing range is
        (None, None)."""
        rb = getattr(self, "read_batcher", None)
        if not wants or rb is None or not rb.coalescing():
            return None
        from .read_batcher import ReadReq

        reqs = [ReadReq(j, oid, o, ln) for j, o, ln in wants]
        try:
            res = rb.gather(pg.pgid, acting, reqs,
                            est_bytes=sum(ln for _, _, ln in wants))
        except Exception as e:
            self.cct.dout("osd", 1,
                          f"{self.whoami} batched range fetch failed, "
                          f"per-shard fallback: {e!r}")
            return None
        out: dict[int, tuple] = {}
        for i, (j, _o, ln) in enumerate(wants):
            row = res.get(i)
            if row is None or row[0] is None or len(row[0]) != ln:
                out[j] = (None, None)
            else:
                out[j] = (row[0], row[1])
        return out

    def _read_cache_invalidate(self, pgid, oid: str) -> None:
        """cephread write-path hook: drop the hot-object cache entry a
        mutation just superseded (the version-bump invalidation)."""
        rc = getattr(self, "read_cache", None)
        if rc is not None:
            rc.invalidate((pgid, oid))

    def _stored_ver(self, cid: str, oid: str) -> int | None:
        """Per-object version xattr (object_info_t analog); None =
        unversioned (legacy object or backfill-pushed wildcard)."""
        try:
            v = self.store.getattr(cid, oid, "ver")
        except (NotFound, KeyError):
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            return None

    def _rmw_apply_local(self, t: Transaction, cid: str, oid: str,
                         full: bytearray, off: int, payload: bytes,
                         xor: bool) -> None:
        """Splice (xor=False) or GF-XOR (xor=True) `payload` into the
        primary's own pre-validated chunk bytes `full` at `off`, keeping
        the hinfo CRC current."""
        if xor:
            seg = (
                np.frombuffer(bytes(full[off:off + len(payload)]), np.uint8)
                ^ np.frombuffer(payload, np.uint8)
            ).tobytes()
        else:
            seg = payload
        full[off:off + len(seg)] = seg
        t.write(cid, oid, off, seg)
        t.setattr(cid, oid, "hinfo", str(crc32c(bytes(full))).encode())

    def _ec_full_splice(self, pg, pool, codec, acting, my_shard, msg,
                        data: bytes, off: int, size) -> MOSDOpReply:
        """RMW slow path: read the whole (possibly degraded) object,
        splice, re-encode everything via the full-object write.  Used when
        the write grows the stripe, the codec is sub-chunked (CLAY), or an
        affected shard's old bytes are unreachable (reconstruction needed).
        """
        old = b""
        if size:
            rd = self._ec_read(pg, codec, acting, MOSDOp(
                tid=self._next_tid(), pool=msg.pool, oid=msg.oid, op="read",
                epoch=self.my_epoch(), ps=pg.ps,
            ))
            if rd.retval != 0:
                # the current generation is temporarily sourceless
                # (unfound-pending): refuse retryably — serving/splicing
                # a stale base would launder a rollback into a fresh
                # version (reference: ops wait on missing objects)
                return MOSDOpReply(
                    tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                    result=f"rmw base unreadable now: {rd.result}",
                )
            old = unpack_data(rd.data) or b""
        buf = bytearray(max(len(old), off + len(data)))
        buf[:len(old)] = old
        buf[off:off + len(data)] = data
        return self._ec_write(pg, pool, codec, acting, my_shard, msg,
                              bytes(buf))

    def _ec_rmw(self, pg, pool, codec, acting, my_shard, msg,
                data: bytes) -> MOSDOpReply:
        """Ranged write / append on an EC object (reference:
        src/osd/ECTransaction.cc :: generate_transactions — the RMW that
        reads the old stripe remainder and re-encodes the touched stripes;
        expressed here as a PARITY-DELTA update, the optimized-EC
        formulation, which is also the device-shaped one: the parity delta is
        one GF matrix apply over just the touched column window).

        Correctness rests on GF-linearity of every registered plugin's
        encode_chunks: parity(new) = parity(old) XOR parity(delta), column
        by column.  Shards that would fuse stale bytes with the delta
        refuse the sub-op (version-jump guard in _handle_sub_write) and
        are rebuilt by log-delta recovery instead."""
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        size = self._ec_object_size(pg, acting, msg.oid)
        if size == "unknown":
            # can't tell whether the object exists (transient faults):
            # refusing retryably is the only safe answer — guessing
            # "absent" would zero-fill over live data
            return MOSDOpReply(tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                               result="object existence unknown (peers "
                                      "unreachable)")
        if size == "absent":
            size = None
        off = (size or 0) if msg.op == "append" else int(msg.off or 0)
        if not data:
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"version": pg.version})
        end = off + len(data)
        if size is None:
            # object doesn't exist yet: a ranged write below `off` reads
            # back as zeros (reference: sparse write semantics)
            return self._ec_write(pg, pool, codec, acting, my_shard, msg,
                                  b"\x00" * off + data)
        L = codec.get_chunk_size(size) if size else 0
        sub_chunks = 1
        try:
            sub_chunks = codec.get_sub_chunk_count()
        except (AttributeError, NotImplementedError):
            pass  # plugin predates the sub-chunk API: classic layout
        try:
            delta_ok = bool(codec.supports_parity_delta())
        except (AttributeError, NotImplementedError):
            delta_ok = False
        if size == 0 or end > k * L or sub_chunks != 1 or not delta_ok:
            # codecs whose encode is not byte-column-local (bitmatrix
            # packet techniques, CLAY sub-chunks, LRC remapping) re-encode
            # the full stripe — a windowed delta would corrupt parity
            return self._ec_full_splice(pg, pool, codec, acting, my_shard,
                                        msg, data, off, size)
        # local pre-validation: the delta fast path needs the primary's
        # own chunk present, rot-free, and version-stamped — the stamp is
        # the authoritative old object version every other shard must
        # match (the primary serialized all prior writes)
        cid = self._cid(pg.pgid, my_shard)
        try:
            my_chunk = bytearray(self.store.read(cid, msg.oid))
        except (NotFound, KeyError):
            return self._ec_full_splice(pg, pool, codec, acting, my_shard,
                                        msg, data, off, size)
        my_ver = self._stored_ver(cid, msg.oid)
        try:
            stored_h = int(self.store.getattr(cid, msg.oid, "hinfo"))
        except (NotFound, KeyError, ValueError):
            stored_h = None
        floor = pg.log.obj_newest.get(msg.oid)
        if (
            my_ver is None
            or (floor is not None and my_ver < floor)
            or len(my_chunk) != L
            or (stored_h is not None and crc32c(bytes(my_chunk)) != stored_h)
        ):
            # unversioned legacy object, unexpected chunk length, or
            # local rot (full-splice reads exclude the rotted chunk and
            # the re-encode heals it)
            return self._ec_full_splice(pg, pool, codec, acting, my_shard,
                                        msg, data, off, size)
        # per-data-shard touched segments: shard j holds object bytes
        # [j*L, (j+1)*L) (contiguous-split layout, ErasureCode.encode_prepare)
        segs: dict[int, tuple[int, bytes]] = {}
        for j in range(k):
            lo, hi = max(off, j * L), min(end, (j + 1) * L)
            if lo < hi:
                segs[j] = (lo - j * L, data[lo - off:hi - off])
        c0 = min(o for o, _ in segs.values())
        c1 = max(o + len(b) for o, b in segs.values())
        w = c1 - c0
        old: dict[int, bytes] = {}
        # cephread: the remote old-byte fetches ride the read batcher
        # when it is coalescing — concurrent RMWs' ranged reads fuse
        # into the flush's single sub-op fan-out (historically this
        # loop paid one round trip PER SHARD PER OP)
        batched = self._rb_fetch_ranges(
            pg, acting, my_shard, msg.oid,
            [(j, o, len(b)) for j, (o, b) in segs.items() if j != my_shard],
        )
        for j, (o, b) in segs.items():
            if j == my_shard:
                old[j] = bytes(my_chunk[o:o + len(b)])
                continue
            if batched is not None:
                ob, over = batched.get(j, (None, None))
            else:
                ob, over = self._fetch_shard_range(
                    pg, acting, j, msg.oid, o, len(b)
                )
            if ob is None or over != my_ver:
                # unreachable, or the holder is a STALE generation whose
                # old bytes would poison the parity delta (the retry-
                # after-partial-apply case): reconstruct via the decode
                # slow path instead, which filters by version
                return self._ec_full_splice(pg, pool, codec, acting,
                                            my_shard, msg, data, off, size)
            old[j] = ob
        # parity delta = encode_chunks(delta window): zero rows for
        # untouched shards, new^old for touched ones; padded to the
        # codec's alignment (zero delta => zero parity delta, trim back)
        W = codec.get_chunk_size(k * w)
        delta = np.zeros((k, W), np.uint8)
        for j, (o, b) in segs.items():
            delta[j, o - c0:o - c0 + len(b)] = (
                np.frombuffer(b, np.uint8) ^ np.frombuffer(old[j], np.uint8)
            )
        parity_delta = np.asarray(
            self._ec_encode_chunks(codec, delta), np.uint8
        )[:, :w]
        new_size = max(size, end)
        version = pg.version + 1
        entry = LogEntry(version, "modify", msg.oid,
                         reqid=getattr(msg, "reqid", None))
        wire_entry = entry.to_list()
        tids: dict[int, int] = {}
        # subop span opens BEFORE the fan-out (sub-ops carry its id as
        # parent); see object_ops._ec_write
        sub_span = TRACER.begin(self._op_trace_ctx(), "subop",
                                entity=self.whoami, rmw=True) \
            if TRACER.enabled else None
        t_sub0 = sub_span.t0 if sub_span is not None else trace_now()
        for shard, osd in enumerate(acting):
            if shard == my_shard or osd < 0 or not self.osdmap.is_up(osd):
                continue
            if shard in segs:
                mode, moff, payload = "range", segs[shard][0], segs[shard][1]
            elif shard >= k:
                mode, moff = "delta", c0
                payload = parity_delta[shard - k].tobytes()
            else:
                mode, moff, payload = None, None, None  # entry+size only
            tid = self._next_tid()
            tids[tid] = shard
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpWrite(
                        tid=tid, pgid=pg.pgid, oid=msg.oid, shard=shard,
                        data=pack_data(payload) if payload is not None
                        else None,
                        crc=crc32c(payload) if payload is not None else None,
                        version=version, entry=wire_entry,
                        epoch=self.my_epoch(), mode=mode, off=moff,
                        over=my_ver, osize=new_size,
                        trace_id=(sub_span.trace_id
                                  if sub_span is not None else None),
                        parent_span=(sub_span.span_id
                                     if sub_span is not None else None),
                    )
                )
            except (OSError, ConnectionError):
                tids.pop(tid, None)
                self.mc.report_failure(osd)
        t = Transaction()
        t.try_create_collection(cid)
        if my_shard in segs:
            o, b = segs[my_shard]
            self._rmw_apply_local(t, cid, msg.oid, my_chunk, o, b, xor=False)
        elif my_shard >= k:
            self._rmw_apply_local(
                t, cid, msg.oid, my_chunk, c0,
                parity_delta[my_shard - k].tobytes(), xor=True,
            )
        t.setattr(cid, msg.oid, "size", str(new_size).encode())
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
        if acked >= pool.min_size:
            return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                               result={"version": pg.version, "acked": acked})
        # structured under-ack refusal: the op IS applied+logged locally;
        # "applied" lets dup detection refuse re-execution on the resend
        return MOSDOpReply(tid=msg.tid, retval=-11, epoch=self.my_epoch(),
                           result={"applied": pg.version, "acked": acked,
                                   "error": "below min_size commits"})

    def _ec_delete(self, pg, acting, my_shard, msg) -> MOSDOpReply:
        version = pg.version + 1
        entry = LogEntry(version, "delete", msg.oid,
                         reqid=getattr(msg, "reqid", None))
        tids: dict[int, int] = {}
        for shard, osd in enumerate(acting):
            if shard == my_shard or osd < 0 or not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            tids[tid] = shard
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpWrite(
                        tid=tid, pgid=pg.pgid, oid=msg.oid, shard=shard,
                        data=None, crc=None, version=version,
                        entry=entry.to_list(), epoch=self.my_epoch(),
                    )
                )
            except (OSError, ConnectionError):
                tids.pop(tid, None)
        cid = self._cid(pg.pgid, my_shard)
        t = Transaction()
        t.try_create_collection(cid)
        try:
            self.store.stat(cid, msg.oid)
            t.remove(cid, msg.oid)
        except (NotFound, KeyError):
            pass
        self._log_txn(t, cid, pg, entry)
        self.store.queue_transaction(t)
        self._read_cache_invalidate(pg.pgid, msg.oid)
        for tid in tids:
            self._wait_reply(tid)
        return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                           result={"version": pg.version})

    def _gather_chunks(
        self, pg, codec, acting, oid: str, want: set[int],
        sizes: dict[int, int] | None = None,
        vers: dict[int, int | None] | None = None,
        stray: bool = False,
        floor: int | None = None,
    ) -> dict[int, bytes]:
        """Fetch chunk bytes for shard ids in `want` (local or remote).
        `sizes`, if given, collects the object-size xattr each replying
        shard reports (for padding-strip when the primary has no copy);
        `vers` likewise collects each shard's stored per-object version
        (None = wildcard) for stale-generation filtering.  `stray` also
        probes non-acting locations for shards the acting map cannot
        serve (see _gather_stray_chunks)."""
        got: dict[int, bytes] = {}
        tids: dict[int, int] = {}
        for shard in sorted(want):
            osd = acting[shard] if shard < len(acting) else -1
            if osd == self.id:
                cid = self._cid(pg.pgid, shard)
                try:
                    # same injection surface a remote shard read passes
                    # through (_handle_sub_read): a primary's own chunk
                    # can report EIO too
                    failpoint("osd.ec.shard_read", cct=self.cct,
                              entity=self.whoami, pgid=pg.pgid,
                              shard=shard, oid=oid)
                    chunk = self.store.read(cid, oid)
                except FailpointCrash:
                    raise
                except (FailpointError, NotFound, KeyError):
                    continue
                try:
                    stored = int(self.store.getattr(cid, oid, "hinfo"))
                except (NotFound, KeyError, ValueError):
                    stored = None
                if stored is not None and crc32c(chunk) != stored:
                    # rotted local chunk counts as missing: reconstruct
                    # from peers rather than decode garbage (hinfo read
                    # check, as in _handle_sub_read)
                    self.cct.dout(
                        "osd", 0,
                        f"{self.whoami} hinfo mismatch on local read "
                        f"{pg.pgid}/{oid} shard {shard}",
                    )
                    continue
                got[shard] = chunk
                if vers is not None:
                    vers[shard] = self._stored_ver(cid, oid)
                continue
            if osd < 0 or not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            tids[tid] = shard
            try:
                self._conn_to_osd(osd).send_message(
                    MECSubOpRead(tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                                 offsets=None, epoch=self.my_epoch())
                )
            except (OSError, ConnectionError):
                tids.pop(tid, None)
        for tid, shard in tids.items():
            rep = self._wait_reply(tid)
            if rep is not None and rep.retval == 0:
                got[shard] = unpack_data(rep.data)
                if sizes is not None and rep.size is not None:
                    sizes[shard] = int(rep.size)
                if vers is not None:
                    vers[shard] = getattr(rep, "ver", None)
        if stray:
            self._stray_upgrade(pg, oid, want, got, sizes, vers, acting,
                                floor)
        return got

    def _stray_upgrade(self, pg, oid: str, want: set[int], got: dict,
                       sizes, vers, acting,
                       floor: int | None = None) -> None:
        """Hunt NON-acting locations (reference: PeeringState's
        missing_loc — recovery reads from any OSD known to hold the
        object, not just the acting set) for two cases an acting
        permutation creates:
        - a shard with NO chunk at all (its new holder never held the
          role) — any copy helps;
        - a shard whose acting chunk is a STALE generation — only a
          copy stamped at (or above) the newest generation seen helps,
          and crucially the stale chunk must NOT suppress the hunt, or
          a current stray that could complete the stripe stays
          invisible and reads fail with too-few chunks.
        Iterates because finding a higher generation can reclassify
        previously-accepted chunks as stale."""
        for _round in range(3):
            present = [v for v in vers.values() if v is not None]
            if floor is not None:
                present.append(floor)
            target = max(present) if present else None
            needs = {
                sh: (target if sh in got else None)
                for sh in sorted(want)
                if sh not in got
                or (target is not None and vers.get(sh) is not None
                    and vers[sh] < target)
            }
            if not needs:
                return
            found = self._probe_strays(pg, oid, needs, acting)
            if not found:
                return
            for shard, (data, ver, size) in found.items():
                got[shard] = data
                if vers is not None:
                    vers[shard] = ver
                if sizes is not None and size is not None:
                    sizes[shard] = size

    PROBE_TIMEOUT = 3.0   # shared deadline for the metadata wave
    FETCH_TIMEOUT = 5.0   # shared deadline for the chunk-fetch wave
    PROBES_PER_SHARD = 16  # bound the walk on big maps (client-path cost)

    def _stray_local(self, pg, oid: str, shard: int, acting,
                     min_ver: int | None):
        """This OSD's own non-acting copy of a shard, if qualifying."""
        holder = acting[shard] if shard < len(acting) else -1
        if holder == self.id:  # acting-local was already tried
            return None
        cid = self._cid(pg.pgid, shard)
        try:
            chunk = self.store.read(cid, oid)
        except (NotFound, KeyError):
            return None
        try:
            stored = int(self.store.getattr(cid, oid, "hinfo"))
        except (NotFound, KeyError, ValueError):
            stored = None
        ver = self._stored_ver(cid, oid)
        if (
            (stored is None or crc32c(chunk) == stored)
            and (min_ver is None or (ver is not None and ver >= min_ver))
        ):
            size = None
            try:
                size = int(self.store.getattr(cid, oid, "size"))
            except (NotFound, KeyError, ValueError):
                pass
            return bytes(chunk), ver, size
        return None

    def _send_stray_read(self, pg, oid: str, shard: int, osd: int,
                         metadata: bool, tids: dict, key) -> None:
        tid = self._next_tid()
        try:
            self._conn_to_osd(osd).send_message(MECSubOpRead(
                tid=tid, pgid=pg.pgid, oid=oid, shard=shard,
                offsets=[] if metadata else None, epoch=self.my_epoch(),
            ))
            tids[tid] = key
        except (OSError, ConnectionError):
            pass

    def _probe_strays(self, pg, oid: str, needs: dict, acting) -> dict:
        """Find qualifying non-acting copies for many shards at once.
        `needs` maps shard -> min_ver (None = any copy qualifies,
        wildcard stamp included; numeric = only a copy with a NUMERIC
        generation >= min_ver).  Returns {shard: (data, ver, size)}.

        Advisor-r4 rework: every network step is a WAVE under one shared
        deadline — worst case is one probe timeout plus one fetch
        timeout, not 16 probes x 3 s x shards.  A per-PG stray-location
        cache (pg.stray_loc, the missing_loc analog) lets repeat
        degraded reads skip the probe wave entirely."""
        needs = dict(needs)
        found: dict = {}
        # 0) our own disk (no network)
        for shard in list(needs):
            local = self._stray_local(pg, oid, shard, acting, needs[shard])
            if local is not None:
                found[shard] = local
                del needs[shard]
        if not needs:
            return found

        def fetch_wave(targets: dict) -> dict:
            """{shard: osd} -> {shard: (data, ver, size)} that qualify;
            drops non-qualifying/err shards from nothing but the wave."""
            tids: dict = {}
            for shard, osd in targets.items():
                self._send_stray_read(pg, oid, shard, osd, False, tids,
                                      (shard, osd))
            reps = self._wait_replies(
                tids, time.monotonic() + self.FETCH_TIMEOUT
            )
            out = {}
            for tid, rep in reps.items():
                shard, osd = tids[tid]
                if rep is None or rep.retval != 0:
                    continue
                ver = getattr(rep, "ver", None)
                min_ver = needs.get(shard)
                if min_ver is not None and (ver is None or ver < min_ver):
                    continue
                out[shard] = (
                    unpack_data(rep.data),
                    ver,
                    int(rep.size) if rep.size is not None else None,
                )
                pg.stray_loc[shard] = osd
            return out

        # 1) cached locations: straight to a fetch wave
        cached = {
            sh: pg.stray_loc[sh] for sh in needs
            if sh in pg.stray_loc and self.osdmap.is_up(pg.stray_loc[sh])
        }
        if cached:
            hit = fetch_wave(cached)
            for shard in cached:
                if shard in hit:
                    found[shard] = hit[shard]
                    del needs[shard]
                else:
                    pg.stray_loc.pop(shard, None)  # stale cache entry
        if not needs:
            return found

        # 2) metadata wave: all candidates of all shards, one deadline.
        # Candidate order (reference: missing_loc built from
        # PastIntervals): past holders of THIS shard first — the only
        # OSDs that can plausibly hold it — then the bounded global walk
        # as a suffix so an INCOMPLETE history still finds a holder.
        probe_tids: dict = {}
        for shard, min_ver in needs.items():
            holder = acting[shard] if shard < len(acting) else -1
            exclude = {self.id, holder}
            candidates = pg.past_intervals.holders_of_shard(shard, exclude)
            seen = set(candidates)
            candidates += [
                osd for osd in range(self.osdmap.max_osd)
                if osd not in exclude and osd not in seen
            ]
            probes = 0
            for osd in candidates:
                if not self.osdmap.is_up(osd):
                    continue
                if probes >= self.PROBES_PER_SHARD:
                    break
                probes += 1
                self.logger.inc("stray_probes")
                self._send_stray_read(pg, oid, shard, osd, True,
                                      probe_tids, (shard, osd))
        reps = self._wait_replies(
            probe_tids, time.monotonic() + self.PROBE_TIMEOUT
        )
        # best holder per shard: highest NUMERIC generation wins (the
        # target only ever rises); wildcard stamps qualify only when
        # min_ver is None
        best: dict = {}
        for tid, rep in reps.items():
            shard, osd = probe_tids[tid]
            if shard in found or rep is None or rep.retval != 0:
                continue
            ver = getattr(rep, "ver", None)
            min_ver = needs.get(shard)
            if min_ver is not None and (ver is None or ver < min_ver):
                continue
            rank = -1 if ver is None else ver
            if shard not in best or rank > best[shard][0]:
                best[shard] = (rank, osd)

        # 3) fetch wave from the best holders
        if best:
            hit = fetch_wave({sh: osd for sh, (_r, osd) in best.items()})
            found.update(hit)
        return found

    # .. cephread: the read batcher's transport/store adapter ..............
    # (osd/read_batcher.py drives these from its flusher thread; bench
    # and tests substitute a local fake with the same surface)
    def rb_local_osd(self) -> int:
        return self.id

    def rb_is_up(self, osd: int) -> bool:
        return self.osdmap.is_up(osd)

    def rb_epoch(self) -> int:
        return self.my_epoch()

    def rb_reply_timeout(self) -> float:
        return float(self.cct.conf.get("osd_subop_reply_timeout"))

    def rb_read_local(self, pgid, shard: int, oid: str, off, ln):
        """Serve one batched descriptor from the local store: (bytes,
        ver, size) or None.  Full-chunk reads pass the same
        ``osd.ec.shard_read`` injection surface and hinfo CRC verify as
        `_gather_chunks`' local branch; ranged reads match
        `_fetch_shard_range`'s local branch (plain length-checked store
        read)."""
        cid = self._cid(pgid, shard)
        if off is not None:
            try:
                b = self.store.read(cid, oid, off, ln)
            except (NotFound, KeyError):
                return None
            if len(b) != ln:
                return None
            return bytes(b), self._stored_ver(cid, oid), None
        try:
            failpoint("osd.ec.shard_read", cct=self.cct,
                      entity=self.whoami, pgid=pgid, shard=shard, oid=oid)
            chunk = self.store.read(cid, oid)
        except FailpointCrash:
            raise
        except (FailpointError, NotFound, KeyError):
            return None
        try:
            stored = int(self.store.getattr(cid, oid, "hinfo"))
        except (NotFound, KeyError, ValueError):
            stored = None
        if stored is not None and crc32c(chunk) != stored:
            self.cct.dout(
                "osd", 0,
                f"{self.whoami} hinfo mismatch on local read "
                f"{pgid}/{oid} shard {shard}",
            )
            return None
        try:
            size = int(self.store.getattr(cid, oid, "size"))
        except (NotFound, KeyError):
            size = None
        return chunk, self._stored_ver(cid, oid), size

    def rb_send_multiread(self, osd: int, pgid, shard: int, reads,
                          epoch: int):
        tid = self._next_tid()
        try:
            self._conn_to_osd(osd).send_message(
                MECSubOpRead(tid=tid, pgid=pgid, oid=None, shard=shard,
                             offsets=None, epoch=epoch, reads=reads)
            )
        except (OSError, ConnectionError):
            return None
        return tid

    def rb_wait_multireads(self, tids, deadline: float) -> dict:
        return self._wait_replies(tids, deadline)

    def _rb_gather_data(self, pg, codec, acting, oid: str, want: set[int],
                        sizes: dict, vers: dict, size_hint):
        """Coalesced stand-in for `_gather_chunks` over acting data
        shards (no stray probing — degraded ops take the historical
        probe path).  Returns the got dict, or None when the batcher is
        absent/not coalescing/failed, in which case the caller falls
        back to the per-op fan-out."""
        rb = getattr(self, "read_batcher", None)
        if rb is None or not rb.coalescing():
            return None
        from .read_batcher import ReadReq

        reqs = [ReadReq(s, oid) for s in sorted(want)]
        est = len(reqs) * (codec.get_chunk_size(size_hint)
                           if size_hint else 4096)
        try:
            res = rb.gather(pg.pgid, acting, reqs, est_bytes=est)
        except Exception as e:
            self.cct.dout("osd", 1,
                          f"{self.whoami} batched gather failed, per-op "
                          f"fallback: {e!r}")
            return None
        got: dict[int, bytes] = {}
        for i, r in enumerate(reqs):
            row = res.get(i)
            if row is None or row[0] is None:
                continue
            got[r.shard] = row[0]
            vers[r.shard] = row[1]
            if row[2] is not None:
                sizes[r.shard] = int(row[2])
        return got

    # .. cephread: ranged degraded decode ..................................
    def _ranged_decode_ok(self, codec) -> bool:
        """Range-limited decode is exact only for plain byte-column-
        local MDS matrix codes with identity placement (the
        `_batch_matrix` property, decode-side): sub-chunked codecs
        (CLAY couples columns across sub-chunk planes) and the numpy
        referee backend keep the full decode + slice path.  The port's
        device codec is ``codec.bitplane`` (ec/plugins/rs.py)."""
        if getattr(codec, "bitplane", None) is None:
            return False
        try:
            return bool(codec.supports_parity_delta()) \
                and codec.get_sub_chunk_count() == 1
        except (AttributeError, NotImplementedError):
            return False

    @staticmethod
    def _read_col_window(msg, k: int, L: int, size: int):
        """Column window (c0, c1) of every chunk that covers the
        requested byte range, or None when the request needs the full
        stripe.  Only a range that lands inside ONE data chunk gets a
        sub-window (a spanning range's column union is [0, L) anyway:
        the first chunk contributes a suffix, the next a prefix)."""
        if not (msg.off or (msg.length or 0) > 0):
            return None
        off = msg.off or 0
        end = min(off + msg.length, size) if msg.length else size
        if off >= end:
            return (0, 0)  # empty result: nothing to decode at all
        c_lo = off // L
        c_hi = (end - 1) // L
        if c_lo != c_hi or c_lo >= k:
            return None
        return (off % L, (end - 1) % L + 1)

    def _rb_decode_window(self, codec, use: dict, k: int,
                          c0: int, c1: int):
        """Decode ONLY columns [c0, c1) of each data chunk through the
        codec's cached decode matrix: {chunk id: [c1-c0] array}, or None
        if a full matrix can't be formed.  Rows are the first k
        available chunks in sorted order — the exact selection
        `RSCodec.decode_chunks` makes, so the windowed bytes are
        bit-identical to full-decode-then-slice.  The apply is fused
        with the flush's other decodes by the read batcher (pooled
        commit + one dispatch); bit-column locality makes the column
        slice exact."""
        rows = tuple(sorted(use))[:k]
        if len(rows) < k:
            return None
        dm, dm_key = codec.bitplane._decode_entry(rows)
        stack = np.stack([np.asarray(use[r], np.uint8)[c0:c1]
                          for r in rows])
        rb = getattr(self, "read_batcher", None)
        if rb is not None:
            out = rb.decode(dm, stack, dm_key)
        else:
            from ..ops.bitplane import apply_matrix
            from ..ops.device_pool import POOL

            x = POOL.put(stack, self.device) if POOL.enabled() else stack
            try:
                # decoded range serializes straight into the client reply
                out = to_host(apply_matrix(dm, x, device=self.device,
                                           mat_key=dm_key))
            finally:
                if x is not stack:
                    POOL.release(x)
        return {i: out[i] for i in range(k)}

    # .. cephread: hot-object cache plumbing ...............................
    def _read_cache_promote(self) -> bool:
        """cephmeter-driven promotion gate: cache a full-object read
        only when the requesting (client, pool) identity has accumulated
        `osd_read_cache_promote_ops` read ops in the per-client
        accounting table (threshold 0 = promote everything) — a heavy
        hitter's working set sticks, a cold scan never churns."""
        thresh = int(self.cct.conf.get("osd_read_cache_promote_ops"))
        if thresh <= 0:
            return True
        st = op_trace()
        acct = st.get("acct") if st is not None else None
        if acct is None:
            return False
        tab, client, pool = acct
        return tab.reads_of(client, pool) >= thresh

    def _ec_read(self, pg, codec, acting, msg) -> MOSDOpReply:
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        my_shard = acting.index(self.id) if self.id in acting else -1
        floor = pg.log.obj_newest.get(msg.oid)
        cache = getattr(self, "read_cache", None)
        if cache is not None and cache.enabled():
            hit = cache.get((pg.pgid, msg.oid), floor)
            if hit is not None:
                self.logger.inc("read_cache_hits")
                obj, size = hit
                if msg.off or (msg.length or 0) > 0:
                    off = msg.off or 0
                    ln = msg.length if msg.length else len(obj) - off
                    obj = obj[off:off + ln]
                return MOSDOpReply(tid=msg.tid, retval=0,
                                   epoch=self.my_epoch(),
                                   data=pack_data(obj),
                                   result={"size": size})
            self.logger.inc("read_cache_misses")
        # size from any shard we can reach (primary's own shard normally)
        size = None
        if my_shard >= 0:
            try:
                size = int(self.store.getattr(
                    self._cid(pg.pgid, my_shard), msg.oid, "size"))
            except (NotFound, KeyError):
                pass
        peer_sizes: dict[int, int] = {}
        vers: dict[int, int | None] = {}
        want_data = set(range(k))
        t_g0 = trace_now()
        got = self._rb_gather_data(pg, codec, acting, msg.oid, want_data,
                                   peer_sizes, vers, size)
        if got is None:
            got = self._gather_chunks(
                pg, codec, acting, msg.oid, want_data, sizes=peer_sizes,
                vers=vers, floor=floor,
            )
        self._op_stage("read_gather", t_g0, trace_now(), shards=len(got))

        got = _current_generation(got, vers, floor)
        missing = want_data - set(got)
        if missing:
            # degraded: consult minimum_to_decode over everything
            # reachable, including stray (non-acting) chunk locations
            avail_probe = self._gather_chunks(
                pg, codec, acting, msg.oid, set(range(k, n)) | missing,
                sizes=peer_sizes, vers=vers, stray=True, floor=floor,
            )
            avail_probe.update(got)
            avail_probe = _current_generation(avail_probe, vers, floor)
            if len(avail_probe) < k:
                return MOSDOpReply(
                    tid=msg.tid, retval=-5, epoch=self.my_epoch(),
                    result=f"unreadable: only {len(avail_probe)} chunks",
                )
            # zero-copy views over the gathered chunk bytes — the host
            # copies happen at the pooled decode seam below, not here
            chunks = {
                s: np.frombuffer(b, dtype=np.uint8)
                for s, b in avail_probe.items()
            }
            L = len(next(iter(chunks.values())))
            size = self._resolve_read_size(size, peer_sizes, vers, k * L)
            need = codec.minimum_to_decode(want_data, set(chunks))
            use = {s: chunks[s] for s in need if s in chunks}
            t_d0 = trace_now()
            win = self._read_col_window(msg, k, L, size) \
                if self._ranged_decode_ok(codec) else None
            if win is not None:
                # ranged fast path: decode ONLY the requested column
                # window through the cached decode matrix — the bytes
                # are identical to full-decode-then-slice, but the
                # kernel sees k x window instead of k x L bytes
                c0, c1 = win
                dec = self._rb_decode_window(codec, use, k, c0, c1) \
                    if c1 > c0 else {}
                if dec is not None:
                    self._op_stage("read_decode", t_d0, trace_now(),
                                   ranged=True, window=c1 - c0)
                    off = msg.off or 0
                    end = min(off + msg.length, size) if msg.length \
                        else size
                    obj = b"" if c1 <= c0 else \
                        np.asarray(dec[off // L], np.uint8)[
                            :end - off].tobytes()
                    return MOSDOpReply(tid=msg.tid, retval=0,
                                       epoch=self.my_epoch(),
                                       data=pack_data(obj),
                                       result={"size": size})
            dec = codec.decode(want_data, use, L)
            self._op_stage("read_decode", t_d0, trace_now(), ranged=False)
            data = b"".join(to_host(dec[i]).tobytes() for i in range(k))
        else:
            data = b"".join(got[i] for i in range(k))
        size = self._resolve_read_size(size, peer_sizes, vers, len(data))
        obj = data[:size]
        if cache is not None and cache.enabled() and not missing \
                and floor is not None and self._read_cache_promote():
            # healthy full-object read by a heavy hitter: cache the
            # assembled object at the PG log's newest version (the
            # validation stamp every later hit is checked against)
            cache.put((pg.pgid, msg.oid), floor, obj, size)
            self.logger.inc("read_cache_inserts")
        if msg.off or (msg.length or 0) > 0:
            off = msg.off or 0
            ln = msg.length if msg.length else len(obj) - off
            obj = obj[off : off + ln]
        return MOSDOpReply(tid=msg.tid, retval=0, epoch=self.my_epoch(),
                           data=pack_data(obj),
                           result={"size": size})

    @staticmethod
    def _resolve_read_size(size, peer_sizes: dict, vers: dict,
                           fallback: int) -> int:
        """Object size for padding-strip: the primary's own xattr if it
        had one, else a size reported by a current-generation shard (a
        stale shard's size xattr predates the newest RMW), else the
        full padded stripe length."""
        if size is not None:
            return size
        if peer_sizes:
            present = [v for v in vers.values() if v is not None]
            target = max(present) if present else None
            good = [
                sz for s, sz in peer_sizes.items()
                if target is None or vers.get(s) in (None, target)
            ]
            return good[0] if good else next(iter(peer_sizes.values()))
        return fallback

