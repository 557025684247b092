"""Objecter — client-side op engine (reference: src/osdc/Objecter.cc ::
op_submit / _calc_target / resend-on-epoch-change; SURVEY.md §3.1 first
hop).

The client holds its own OSDMap (pushed by the mon subscription), computes
each op's target primary locally (no metadata server — the CRUSH property),
and resends ops when:
- the reply is -ESTALE-like (-116: wrong primary; the map moved),
- the target connection dies,
- a new map arrives while ops are in flight and their target changed
  (``_scan_requests``).
"""
from __future__ import annotations

import threading
from time import monotonic as _monotonic

from ..common.lockdep import make_lock
from ..common.throttle import Throttle
from ..common.tracer import TRACER, sampled_ctx, trace_now
from ..msg import Dispatcher, Messenger
from ..msg.messenger import POLICY_LOSSY
from ..osd.osdmap import object_ps
from ..osd.messages import (
    MOSDOp,
    MOSDOpReply,
    MWatchNotify,
    MWatchNotifyAck,
    pack_data,
    unpack_data,
)


#: stands in a waiter's reply slot when a new map moved its op's target:
#: the op is resent on the new map (reference: Objecter::_scan_requests)
_RETARGET = object()


class Objecter(Dispatcher):
    def __init__(self, cct, mon_client, name: str = "client"):
        self.cct = cct
        self.mc = mon_client
        self.messenger = Messenger.create(cct, name)
        self.messenger.default_policy = POLICY_LOSSY
        self.messenger.add_dispatcher(self)
        self._lock = make_lock("objecter::lock")
        self._cond = threading.Condition(self._lock)
        self._tid = 0
        # instance nonce: makes reqids unique across Objecter restarts
        # that reset the tid counter (reference: osd_reqid_t's name+inc)
        import uuid

        self._nonce = uuid.uuid4().hex[:12]
        # lingering watches: (pool, oid, cookie) -> {"callback": fn}
        self._watches: dict[tuple, dict] = {}
        self._cookie = 0
        self._relinger_epoch = 0     # newest epoch watches were re-sent at
        self._relingering = False    # single relinger loop at a time
        self._linger_kick = False    # a map arrived while relinging
        self._linger_lock = make_lock("objecter::linger")
        self._replies: dict[int, MOSDOpReply] = {}
        self._outstanding: set[int] = set()
        # tid -> (pool, oid, op, primary) of each op in flight, for the
        # resend scan on a map push
        self._targets: dict[int, tuple] = {}
        # admission throttles (reference: Objecter's op budget —
        # objecter_inflight_ops / objecter_inflight_op_bytes).  These
        # are the backpressure sink of the whole write path: an op
        # stalled downstream (e.g. at the OSD write-batcher's queue
        # throttle) keeps its budget here, so sustained overload blocks
        # NEW client ops at admission instead of piling work mid-stack.
        self._op_throttle = Throttle("objecter::inflight_ops", 0)
        self._bytes_throttle = Throttle("objecter::inflight_op_bytes", 0)
        self.mc.subscribe_osdmap(callback=self._on_new_map)

    def _on_new_map(self, m) -> None:
        """Map-push hook: resend every op in flight whose primary the new
        map moved (an op sent to an OSD that went down would otherwise
        wait out its whole timeout); and a new map may mean a new primary
        that has never heard of our watches — re-register them off-thread
        (linger resend; runs even for an idle watcher that submits no
        ops)."""
        self._scan_requests(m)
        if not self._watches:
            return
        with self._linger_lock:
            self._linger_kick = True
        threading.Thread(target=self._relinger_guarded, daemon=True).start()  # noqa: CL13 — fire-and-forget by design: the kick flag dedups to at most one live relinger, and it self-terminates when the flag stays clear

    def _relinger_guarded(self) -> None:
        """At most one relinger loop runs; the `kick` flag (set under
        the lock by every map push) makes the exit decision atomic with
        clearing `_relingering`, so an epoch that arrives mid-flight is
        either handled by this loop's next pass or by the push's own
        thread — never silently skipped."""
        with self._linger_lock:
            if self._relingering:
                return
            self._relingering = True
        try:
            while True:
                with self._linger_lock:
                    self._linger_kick = False
                m = self.mc.osdmap
                target = m.epoch if m is not None else 0
                if target > self._relinger_epoch:
                    self._relinger()
                    self._relinger_epoch = target
                with self._linger_lock:
                    if not self._linger_kick:
                        self._relingering = False
                        return
        finally:
            with self._linger_lock:
                self._relingering = False

    def shutdown(self) -> None:
        self.messenger.shutdown()

    def _scan_requests(self, m) -> None:
        """Wake the waiter of every op in flight whose target `m` moves
        (reference: Objecter::_scan_requests); it resends on the new map
        under the same reqid, so a primary that applied the op before it
        went away cannot make it apply twice."""
        if m is None:
            return
        with self._lock:
            moved = [tid for tid, (pool, oid, op, target) in self._targets.items()
                     if tid not in self._replies
                     and self._target_in(m, pool, oid, op) != target]
            for tid in moved:
                self._replies[tid] = _RETARGET
            if moved:
                self._cond.notify_all()

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MOSDOpReply):
            with self._lock:
                # drop replies for tids nobody waits on any more (late
                # replies after a timeout/retry would otherwise accumulate
                # forever in a long-lived client)
                if msg.tid in self._outstanding:
                    self._replies[msg.tid] = msg
                    self._cond.notify_all()
            return True
        if isinstance(msg, MWatchNotify):
            # watcher side of notify: fire the callback off-thread (a
            # slow callback must not stall the messenger) and ack so the
            # notifier's collect phase completes
            entry = self._watches.get((msg.pool, msg.oid, msg.cookie))
            if entry is not None:
                cb = entry["callback"]
                data = unpack_data(msg.data) or b""

                def run(cb=cb, nid=msg.notify_id, ck=msg.cookie, d=data):
                    try:
                        cb(nid, ck, d)
                    except Exception as e:
                        # user callback: contain it, but leave a trace
                        if self.cct:
                            self.cct.dout(
                                "objecter", 0,
                                f"watch callback cookie={ck} raised: {e!r}")

                threading.Thread(target=run, daemon=True).start()  # noqa: CL13 — fire-and-forget by design: user watch callbacks run off the reader thread and must not be joined from dispatch
            try:
                conn.send_message(MWatchNotifyAck(
                    notify_id=msg.notify_id, pool=msg.pool, oid=msg.oid,
                    cookie=msg.cookie,
                ))
            except (OSError, ConnectionError):
                pass
            return True
        return False

    # -- watch / notify (linger ops) ---------------------------------------
    def watch(self, pool_id: int, oid: str, callback) -> int:
        with self._lock:
            self._cookie += 1
            cookie = self._cookie
        self._watches[(pool_id, oid, cookie)] = {"callback": callback}
        try:
            rep = self.op_submit(pool_id, oid, "watch",
                                 data={"cookie": cookie})
        except Exception:
            # a failed registration must not leave a phantom entry that
            # the next map push re-lingers behind the caller's back
            self._watches.pop((pool_id, oid, cookie), None)
            raise
        if rep.retval != 0:
            self._watches.pop((pool_id, oid, cookie), None)
            raise IOError(f"watch {oid!r}: {rep.retval} {rep.result}")
        return cookie

    def unwatch(self, pool_id: int, oid: str, cookie: int) -> None:
        self._watches.pop((pool_id, oid, cookie), None)
        self.op_submit(pool_id, oid, "unwatch", data={"cookie": cookie})

    def _relinger(self) -> None:
        """Re-register every lingering watch (reference: the Objecter
        resends linger ops after a map change, which is what makes a
        watch survive primary failover — the new primary has no
        in-memory watch state until we tell it)."""
        for (pool_id, oid, cookie) in list(self._watches):
            try:
                self.op_submit(pool_id, oid, "watch",
                               data={"cookie": cookie}, attempts=2)
            except (ConnectionError, OSError):
                pass  # next map change retries

    # -- targeting ---------------------------------------------------------
    # mutations route to write_tier, everything else to read_tier
    # (reference: Objecter::_calc_target's CEPH_OSD_FLAG_WRITE split)
    _WRITE_OPS = frozenset(
        {"write_full", "write", "append", "delete", "setxattr",
         "omap_set", "omap_rm", "omap_clear", "exec", "watch", "unwatch",
         "notify"}
    )

    def _resolve_overlay(self, m, pool_id: int, op: str,
                         ignore_overlay: bool) -> int:
        """Cache-tier overlay redirect (reference: Objecter::_calc_target
        honoring pg_pool_t::read_tier/write_tier unless the op carries
        CEPH_OSD_FLAG_IGNORE_OVERLAY).  Pool listings stay on the pool
        the caller named — `rados ls` on the base enumerates the base."""
        pool = m.pools.get(pool_id)
        if pool is None or ignore_overlay or op in ("list", "scrub", "scrub-noprepair"):
            return pool_id
        tier = pool.write_tier if op in self._WRITE_OPS else pool.read_tier
        if tier >= 0 and tier in m.pools:
            return tier
        return pool_id

    def _min_size_unreachable(self, m, pool_id: int, oid: str,
                              op: str) -> bool:
        """True when the local map proves the object's PG cannot reach
        min_size (fewer than min_size acting shards are up) — the state
        where an EAGAIN retry loop cannot succeed until the map changes."""
        if m is None:
            return False
        pool = m.pools.get(pool_id)
        if pool is None:
            return False
        try:
            ps = (int(oid[4:]) if op in ("list", "scrub", "scrub-noprepair")
                  and oid.startswith(":pg:") else object_ps(oid, pool.pg_num))
            _up, _upp, acting, _primary = m.pg_to_up_acting_osds(pool_id, ps)
        except Exception:
            return False
        reachable = sum(1 for o in acting if o >= 0 and m.is_up(o))
        return reachable < pool.min_size

    @staticmethod
    def _pg_of(pool, oid: str, op: str) -> int:
        if op in ("list", "scrub", "scrub-noprepair") and oid.startswith(":pg:"):
            # pg-targeted pseudo-oid — honored by the OSD only for these
            # ops; anything else treats ':pg:*' as a normal name
            return int(oid[4:])
        return object_ps(oid, pool.pg_num)

    @classmethod
    def _target_in(cls, m, pool_id: int, oid: str, op: str) -> tuple:
        """(primary, its address) of the op in map `m`; (-1, None) when
        it has none there."""
        pool = m.pools.get(pool_id)
        if pool is None:
            return -1, None
        primary = m.pg_to_up_acting_osds(pool_id, cls._pg_of(pool, oid, op))[3]
        addr = m.osd_addrs.get(primary)
        return primary, tuple(addr) if addr is not None else None

    def _calc_target(
        self, pool_id: int, oid: str, op: str = ""
    ) -> tuple[int, tuple]:
        """reference: Objecter::_calc_target — pg from the object name,
        primary from the local map."""
        m = self.mc.osdmap
        if m is None:
            raise ConnectionError("no osdmap yet")
        pool = m.pools.get(pool_id)
        if pool is None:
            raise KeyError(f"no pool {pool_id}")
        ps = self._pg_of(pool, oid, op)
        _up, _upp, _acting, primary = m.pg_to_up_acting_osds(pool_id, ps)
        addr = m.osd_addrs.get(primary)
        if primary < 0 or addr is None:
            raise ConnectionError(f"pg {pool_id}.{ps} has no primary")
        return primary, tuple(addr)

    # -- ops ---------------------------------------------------------------
    def op_submit(self, pool_id: int, oid: str, op: str,
                  data: bytes | None = None, **kw):
        """Submit; blocks for the reply, retrying across map changes.

        Admission rides the objecter_inflight_ops /
        objecter_inflight_op_bytes throttles (common/throttle.py
        Throttle, reference: Objecter's op budget): a full window blocks
        new logical ops until completions drain it, FIFO-fair.  An op
        larger than the whole byte budget is admitted only once the
        window is empty, rather than deadlocking (Throttle's oversize
        rule).
        """
        my_bytes = (len(data)
                    if isinstance(data, (bytes, bytearray, memoryview))
                    else 0)
        conf = self.cct.conf if self.cct else None
        # cephtrace birth: ONE head-based coin flip per logical op (the
        # trace context then rides every resend attempt unchanged);
        # tracing disabled = this single attribute check inside
        # sampled_ctx, nothing else on the path.  trace_tail_latency_ms
        # arms tail sampling: a losing flip still mints a PROVISIONAL
        # context whose spans buffer until this op's completion latency
        # renders the promote/discard verdict (cephmeter).
        root_span = None
        tail_ms = 0.0
        provisional = False
        t_e2e0 = 0.0
        if TRACER.enabled:
            rate = float(conf.get("trace_sampling_rate")) if conf else 1.0
            tail_ms = (float(conf.get("trace_tail_latency_ms"))
                       if conf else 0.0)
            tctx = sampled_ctx(rate, tail=tail_ms > 0.0)
            provisional = TRACER.is_provisional(
                tctx.trace_id if tctx is not None else None)
            root_span = TRACER.begin(
                tctx, "op_submit",
                entity=self.cct.name if self.cct else "client",
                op=op, pool=pool_id, oid=oid, nbytes=my_bytes,
            )
            t_e2e0 = trace_now()
        max_ops = int(conf.get("objecter_inflight_ops")) if conf else 0
        max_bytes = int(conf.get("objecter_inflight_op_bytes")) if conf else 0
        if max_ops != self._op_throttle.max:
            self._op_throttle.reset_max(max_ops)
        if max_bytes != self._bytes_throttle.max:
            self._bytes_throttle.reset_max(max_bytes)
        # one combined admission deadline across both throttles, like
        # the single wait_for this replaced — not timeout twice over
        timeout = kw.get("timeout", 30.0)
        deadline = _monotonic() + timeout
        if not self._op_throttle.get(1, timeout=timeout):
            # throttle-starved ops are exactly what tracing is for: end
            # the root span with the error rather than dropping it (and
            # a provisional trace that starved at admission is a
            # straggler by definition — promote it)
            TRACER.end(root_span, error="inflight-op throttle full")
            if provisional and root_span is not None:
                TRACER.promote(root_span.trace_id, reason="throttle")
            raise ConnectionError(
                f"op {op} {oid!r}: inflight-op throttle full "
                f"({self._op_throttle.current}/{max_ops} ops)")
        remain = max(0.0, deadline - _monotonic())
        if not self._bytes_throttle.get(my_bytes, timeout=remain):
            self._op_throttle.put(1)
            TRACER.end(root_span, error="inflight-byte throttle full")
            if provisional and root_span is not None:
                TRACER.promote(root_span.trace_id, reason="throttle")
            raise ConnectionError(
                f"op {op} {oid!r}: inflight-byte throttle full "
                f"({self._bytes_throttle.current}/{max_bytes} bytes)")
        try:
            rep = self._op_submit(pool_id, oid, op, data=data,
                                  _trace_span=root_span, **kw)
            TRACER.end(root_span, retval=rep.retval)
            return rep
        except BaseException as e:
            TRACER.end(root_span, error=repr(e))
            raise
        finally:
            if provisional and root_span is not None:
                # the client-side tail verdict: a provisional trace
                # whose e2e crossed the threshold is kept; otherwise
                # discard — unless a daemon (complaint-time promotion
                # at the primary) already promoted it, which wins
                e2e_ms = (trace_now() - t_e2e0) * 1e3
                if e2e_ms >= tail_ms:
                    TRACER.promote(root_span.trace_id,
                                   reason="client_e2e")
                else:
                    TRACER.discard(root_span.trace_id)
            self._bytes_throttle.put(my_bytes)
            self._op_throttle.put(1)

    def _op_submit(
        self,
        pool_id: int,
        oid: str,
        op: str,
        data: bytes | None = None,
        off: int = 0,
        length: int = 0,
        timeout: float = 30.0,
        attempts: int = 8,
        snapid: int | None = None,
        ignore_overlay: bool = False,
        snapc_seq: int = 0,
        _trace_span=None,
    ):
        """The retry loop under op_submit's admission throttle."""
        import time as _time

        last = None
        # ONE logical-op id across every resend attempt: a reply lost in
        # flight after the primary applied must not re-execute the op
        # (append would double-append; an RMW would double-apply) — the
        # primary's dup cache answers the resend instead
        with self._lock:
            self._tid += 1
            logical_tid = self._tid
        reqid = f"{self._nonce}:{logical_tid}"
        # -EAGAIN refusals (degraded below min_size, existence unknown,
        # op in flight) are TIME-bounded, not attempt-bounded: recovery
        # may legitimately need longer than 8 quick retries to restore
        # min_size, and the op is already durably logged in the
        # 'applied' case — giving up early turns a pending success into
        # a spurious client error.  objecter_eagain_patience overrides
        # for callers that would rather fail fast against a pool that
        # cannot reach min_size (advisor r3)
        patience = (self.cct.conf.get("objecter_eagain_patience")
                    if self.cct else 0.0)
        if not patience:
            patience = max(60.0, 2 * timeout)
        eagain_deadline = _time.monotonic() + patience
        hard = 0
        while hard < attempts:
            m = self.mc.osdmap
            # overlay redirect re-resolves every attempt: a mid-op
            # set-overlay / remove-overlay retargets the resend
            target_pool = (
                self._resolve_overlay(m, pool_id, op, ignore_overlay)
                if m is not None else pool_id
            )
            # snap context rides every mutation (reference: MOSDOp's
            # SnapContext) so a primary whose map lags a fresh mksnap
            # still clones before overwriting
            snap_seq = 0
            if m is not None and op in ("write_full", "write", "append",
                                        "delete"):
                p = m.pools.get(target_pool)
                # newest LIVE snap, not snap_seq: after the last rmsnap
                # there is nothing left to preserve, and a stale high seq
                # would make primaries mint un-trimmable clones forever
                snap_seq = max(p.snaps, default=0) if p is not None else 0
                # self-managed context (reference: the caller-supplied
                # SnapContext CephFS/RBD ride): the MDS allocates snapids
                # outside the pool registry, so the per-op seq wins
                snap_seq = max(snap_seq, snapc_seq)
            try:
                _osd, addr = self._calc_target(target_pool, oid, op)
            except (ConnectionError, KeyError) as e:
                last = str(e)
                hard += 1
                self._refresh_map(m)
                continue
            with self._lock:
                self._tid += 1
                tid = self._tid
                self._outstanding.add(tid)
                self._targets[tid] = (target_pool, oid, op, (_osd, addr))
            # a map pushed between _calc_target and the registration
            # above was scanned without this op: scan the newest now
            m_now = self.mc.osdmap
            if m_now is not m:
                self._scan_requests(m_now)
            try:
                conn = self.messenger.connect(addr)
                # bytes payloads ride base64; structured payloads (xattr
                # update maps) ride as-is in the JSON body
                wire_data = (
                    pack_data(data)
                    if isinstance(data, (bytes, bytearray, memoryview))
                    else data
                )
                conn.send_message(
                    MOSDOp(
                        tid=tid, pool=target_pool, oid=oid, op=op,
                        data=wire_data,
                        epoch=m.epoch if m else 0, off=off, length=length,
                        snapid=snapid, snap_seq=snap_seq, reqid=reqid,
                        trace_id=(_trace_span.trace_id
                                  if _trace_span is not None else None),
                        parent_span=(_trace_span.span_id
                                     if _trace_span is not None else None),
                    )
                )
            except (OSError, ConnectionError) as e:
                last = str(e)
                hard += 1
                with self._lock:
                    self._outstanding.discard(tid)
                    self._targets.pop(tid, None)
                self._refresh_map(m)
                continue
            with self._lock:
                ok = self._cond.wait_for(
                    lambda: tid in self._replies, timeout=timeout
                )
                rep = self._replies.pop(tid, None) if ok else None
                self._outstanding.discard(tid)
                self._targets.pop(tid, None)
            if rep is _RETARGET:
                # a newer map moved the primary: resend there at once
                # (time-bounded by the same patience as -EAGAIN; a map
                # change is what every attempt below waits for anyway)
                last = "target moved by a new map"
                if _time.monotonic() >= eagain_deadline:
                    break
                continue
            if rep is None:
                last = "op timed out"
                hard += 1
                self._refresh_map(m)
                continue
            if rep.retval == -116:  # wrong primary: map changed under us
                last = "stale map"
                hard += 1
                self._refresh_map(m)
                continue
            if rep.retval == -122:
                # EDQUOT: the pool is over quota — final, no retry (only
                # deletes or a raised quota can clear it)
                return rep
            if rep.retval == -11:  # not enough shards yet; let it settle
                last = rep.result
                if _time.monotonic() >= eagain_deadline:
                    break
                # min_size short-circuit (advisor r3 / r4 verdict #7):
                # when OUR OWN map already shows the PG cannot reach
                # min_size (too few acting shards up), waiting out the
                # full patience is pointless — only a map change can
                # help, so wait for one map push and fail fast if the
                # map still says unreachable
                if self._min_size_unreachable(m, target_pool, oid, op):
                    self._refresh_map(m)
                    m2 = self.mc.osdmap
                    if (
                        (m2 is None or m is None or m2.epoch == m.epoch
                         or self._min_size_unreachable(m2, target_pool,
                                                       oid, op))
                    ):
                        last = (f"{last} (map shows min_size "
                                f"unreachable; failing fast)")
                        break
                    continue
                _time.sleep(0.3)
                self._refresh_map(m)
                continue
            return rep
        raise ConnectionError(f"op {op} {oid!r} failed after retries: {last}")

    def _refresh_map(self, old) -> None:
        """Wait briefly for a newer epoch (reference: the Objecter blocks
        ops on map gaps; subscriptions push the new map)."""
        want = (old.epoch + 1) if old is not None else 1
        try:
            self.mc.wait_for_osdmap(min_epoch=want, timeout=3.0)
        except TimeoutError:
            pass

