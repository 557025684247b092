"""ReadBatcher — the coalescing gather/decode layer behind `_ec_read`;
the port's counterpart of ceph_tpu/osd/read_batcher.py (ROADMAP
"Coalesced, device-resident READ plane"; the read-side twin of
osd/write_batcher.py).

arXiv:1709.05365's finding — that online-EC latency is dominated by the
queueing structure around the codec, not the GF math — applies
symmetrically to reads: a GET-heavy workload (RGW GETs, RBD boot
storms) used to walk the stack one op at a time, paying a per-op sub-op
fan-out for its chunk gather and, when degraded, a per-op
apply dispatch for its decode.  The batcher coalesces
both seams across concurrent ops:

- **Gather coalescing**: every shard-read a flush needs — `_ec_read`
  data-chunk gathers AND RMW old-byte range fetches — is grouped by
  (PG, shard, target OSD) and sent as ONE multi-oid ``MECSubOpRead``
  (the ``reads`` field generalizes PR-13's multi-range machinery), so a
  flush performs one sub-op fan-out no matter how many ops it carries.
  Replies are demuxed back per descriptor, and the per-entry semantics
  (``osd.ec.shard_read`` failpoint, hinfo CRC verify, stale-generation
  version echo) match the historical per-op path exactly.

- **Decode coalescing**: degraded stripes decode through the codec's
  CACHED decode matrix (``_decode_entry``), and all stripes of a flush
  sharing a matrix fuse along the byte-column axis into ONE K1 launch
  on the card — the input stacks commit through pinned staging into
  ``ops/device_pool.py``'s pool, and per-op column windows are demuxed
  back bit-identically.  GF matrix application is byte-column-local
  (the same property the write batcher and the RMW parity delta rest
  on), so fusing changes scheduling, never bytes.

Flush policy mirrors the write batcher: size/byte caps
(``osd_read_batch_max_ops`` / ``osd_read_batch_max_bytes``) flush
immediately; an absolute window (``osd_read_batch_window_ms``) bounds
the first op's wait; an inter-arrival gap (window/8) flushes as soon as
arrivals stop.  Admission rides a ``Throttle`` sized at a few windows
of estimated bytes, so a saturated read plane blocks op threads at
admission and the stall propagates to the client's inflight budget.
Ops fall back to the historical inline path when coalescing is off
(window 0, stopped, a ``crash`` failpoint latched the batcher off) or
the backend sentinel has latched degraded — reads must keep flowing on
a sick accelerator, so a degraded sentinel bypasses the batch plane
entirely rather than trusting a pooled decode.

The batcher runs on ``device`` (``cuda`` unless ``device="cpu"``; without
a card it raises).  Its boundary keeps the reference's host contract:
numpy in, numpy out (decoded bytes go into client replies).

Fault injection: ``osd.read_batcher.gather`` fires at the head of every
flush.  ``error`` fails EVERY op in the batch (each re-runs inline or
surfaces EIO upstream — no wrong bytes are ever served); ``delay(s)``
stalls the flush; ``crash`` additionally latches coalescing off.  A
failed build or launch fails the batch like ``error``; nothing retries
on the CPU or on the kernel's plain version.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..common.device import resolve_device
from ..common.failpoint import FailpointCrash, failpoint
from ..common.kernel_telemetry import SENTINEL, TELEMETRY
from ..common.lockdep import make_lock
from ..common.throttle import Throttle
from ..common.tracer import TRACER, op_trace, trace_now
from ..ops.bitplane import apply_matrix, current_backend
from ..ops.device_pool import POOL, commit
from .messages import unpack_data


class ReadReq:
    """One shard-read descriptor: acting-slot `shard`, object `oid`,
    and an optional byte range (off None = whole chunk)."""

    __slots__ = ("shard", "oid", "off", "ln")

    def __init__(self, shard: int, oid: str,
                 off: int | None = None, ln: int | None = None):
        self.shard = shard
        self.oid = oid
        self.off = off
        self.ln = ln


class _PendingRead:
    """One queued op: either a `gather` (a list of `ReadReq`s against
    one PG's acting set) or a `decode` (a [rows, W] stack to multiply
    through a cached decode matrix).  `results` is the demuxed payload:
    gather -> {req index: (bytes, ver, size) | None}, decode -> the
    [k, W] decoded array."""

    __slots__ = ("kind", "pgid", "acting", "reqs", "dm", "dm_key",
                 "stack", "nbytes", "arrival", "event", "results",
                 "error", "admitted", "tctx", "tracked", "acct",
                 "queued_at")

    def __init__(self, kind: str, nbytes: int):
        self.kind = kind
        self.pgid = None
        self.acting = None
        self.reqs: list[ReadReq] = []
        self.dm = None
        self.dm_key = None
        self.stack = None
        self.nbytes = nbytes
        self.arrival = time.monotonic()
        self.event = threading.Event()
        self.results = None
        self.error: BaseException | None = None
        self.admitted = False
        self.tctx = None
        self.tracked = None
        self.acct = None
        self.queued_at = 0.0


class ReadBatcher:
    """Gather/decode coalescer (see module docstring).

    `io` is the transport/store adapter the flusher drives — the OSD
    itself in the daemon (ECBackendMixin's ``rb_*`` methods), a local
    fake in bench/tests:

    - ``rb_local_osd() -> int``
    - ``rb_is_up(osd) -> bool``
    - ``rb_read_local(pgid, shard, oid, off, ln) -> (bytes|None, ver, size)``
    - ``rb_send_multiread(osd, pgid, shard, reads, epoch) -> tid | None``
    - ``rb_wait_multireads(tids, deadline) -> {tid: reply}``
    - ``rb_epoch() -> int``
    - ``rb_reply_timeout() -> float``
    """

    #: admission throttle holds this many byte-caps of queued work
    QUEUE_WINDOWS = 4
    #: ceiling on one op's wait for admission into a saturated queue
    ADMIT_TIMEOUT = 30.0
    #: ceiling on one op's wait for its flush (window + fan-out + decode)
    OP_TIMEOUT = 60.0

    def __init__(self, cct, io, logger=None, entity: str = "", device=None):
        self._cct = cct
        #: where the decodes run: ``cuda`` unless ``device="cpu"``
        self._device = resolve_device(device)
        self._io = io
        self._logger = logger
        self._entity = entity or (cct.name if cct is not None else "")
        self._lock = make_lock("osd::read_batcher")
        self._cond = threading.Condition(self._lock)
        self._queue: list[_PendingRead] = []
        self._queued_bytes = 0
        self._flush_asap = False
        self._stop_flag = False
        self._crashed = False
        self._thread: threading.Thread | None = None
        self._admission = Throttle(
            "read_batcher::queue",
            self._max_bytes() * self.QUEUE_WINDOWS,
        )
        self._stats = {"flushes": 0, "ops": 0, "bytes": 0, "inline": 0,
                       "fanouts": 0, "decode_groups": 0}

    # -- config (runtime-changeable: read per use) -------------------------
    def _window(self) -> float:
        if self._cct is None:
            return 0.0
        return max(
            0.0, float(self._cct.conf.get("osd_read_batch_window_ms"))) / 1e3

    def _max_ops(self) -> int:
        if self._cct is None:
            return 1
        return max(1, int(self._cct.conf.get("osd_read_batch_max_ops")))

    def _max_bytes(self) -> int:
        if self._cct is None:
            return 0
        return max(0, int(self._cct.conf.get("osd_read_batch_max_bytes")))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cond:
            if self._thread is not None:
                return
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._flush_loop,
                name=f"{self._entity}-rb-flush", daemon=True,
            )
        self._thread.start()

    def stop(self) -> None:
        """Drain-and-stop: queued ops are flushed (shutdown flush), then
        the flusher exits; later submits run inline."""
        with self._cond:
            self._stop_flag = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    def coalescing(self) -> bool:
        """True when submits will be batched rather than run inline.
        A degraded backend sentinel bypasses the batch plane: reads
        must keep flowing on a sick accelerator, so every op takes the
        historical per-op path until the sentinel clears."""
        with self._lock:
            return (self._thread is not None and not self._stop_flag
                    and not self._crashed) and self._window() > 0.0 \
                and not SENTINEL.is_degraded

    # -- introspection (tests / bench) -------------------------------------
    @property
    def admission(self) -> Throttle:
        return self._admission

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def flush_now(self) -> None:
        """Force the current queue out without waiting for window/caps."""
        with self._cond:
            self._flush_asap = True
            self._cond.notify_all()

    def _use_pool(self) -> bool:
        if self._cct is not None \
                and not bool(self._cct.conf.get("ec_device_pool")):
            return False
        return POOL.enabled()

    # -- submit: gathers ---------------------------------------------------
    def gather(self, pgid, acting, reqs: list[ReadReq],
               est_bytes: int) -> dict:
        """Blocking convenience: coalesced shard gather for one op.
        Returns {req index: (bytes, ver, size) | None} — None rows are
        missing/EIO/timed-out shards, exactly as the per-op path skips
        them."""
        return self.gather_wait(self.gather_submit(pgid, acting, reqs,
                                                   est_bytes))

    def gather_submit(self, pgid, acting, reqs: list[ReadReq],
                      est_bytes: int) -> _PendingRead:
        """Queue one op's shard-read descriptors and return its ticket
        (every ticket MUST be passed to gather_wait — it holds admission
        budget until then).  `est_bytes`: the caller's byte estimate
        (sum of ranged lengths / k x chunk-size) for throttle sizing —
        an estimate is fine, backpressure only needs proportionality."""
        p = _PendingRead("gather", max(1, int(est_bytes)))
        p.pgid = pgid
        p.acting = list(acting)
        p.reqs = list(reqs)
        return self._submit(p)

    def gather_wait(self, p: _PendingRead) -> dict:
        return self._wait(p)

    # -- submit: decodes ---------------------------------------------------
    def decode(self, dm: np.ndarray, stack: np.ndarray,
               dm_key: str | None = None) -> np.ndarray:
        """Blocking convenience: [rows, W] surviving-chunk stack in,
        [k, W] decoded data out, bit-identical to
        ``apply_matrix(dm, stack)``; all decodes of a flush sharing
        `dm` fuse into one pooled dispatch."""
        return self.decode_wait(self.decode_submit(dm, stack, dm_key))

    def decode_submit(self, dm: np.ndarray, stack: np.ndarray,
                      dm_key: str | None = None) -> _PendingRead:
        stack = np.ascontiguousarray(stack, dtype=np.uint8)
        p = _PendingRead("decode", stack.nbytes)
        p.dm = np.ascontiguousarray(dm, dtype=np.uint8)
        p.dm_key = dm_key
        p.stack = stack
        return self._submit(p)

    def decode_wait(self, p: _PendingRead) -> np.ndarray:
        return self._wait(p)

    # -- submit plumbing ---------------------------------------------------
    def _submit(self, p: _PendingRead) -> _PendingRead:
        st = op_trace()
        if st is not None:
            if TRACER.enabled:
                p.tctx = st.get("ctx")
            p.tracked = st.get("tracked")
            p.acct = st.get("acct")
        if not self.coalescing():
            self._run_inline(p)
            return p
        # backpressure: block HERE, at admission — the op thread's
        # upstream inflight budget carries the stall to the client
        cap = self._max_bytes() * self.QUEUE_WINDOWS
        if cap != self._admission.max:
            self._admission.reset_max(cap)
        t_adm0 = trace_now()
        if not self._admission.get(p.nbytes, timeout=self.ADMIT_TIMEOUT):
            raise IOError(
                f"read batcher admission timed out "
                f"({self._admission.current} B queued, cap {cap} B)"
            )
        p.admitted = True
        try:
            t_adm1 = trace_now()
            if p.acct is not None:
                tab, client, pool = p.acct
                tab.record_stage(client, pool, "admission",
                                 t_adm1 - t_adm0)
            if p.tracked is not None:
                p.tracked.stage_add("admission", t_adm1 - t_adm0)
            if p.tctx is not None:
                TRACER.record(p.tctx, "admission", entity=self._entity,
                              t0=t_adm0, t1=t_adm1, nbytes=p.nbytes)
            p.queued_at = t_adm1
            enqueued = False
            with self._cond:
                if not (self._stop_flag or self._crashed):
                    enqueued = True
                    self._queue.append(p)
                    self._queued_bytes += p.nbytes
                    # only the flusher waits on the shared condition;
                    # per-op completion rides p.event (no herd)
                    self._cond.notify_all()
            if not enqueued:  # raced a stop/crash: run inline
                self._run_inline(p)
            return p
        except Exception:
            # nobody will _wait() on a ticket whose submit raised —
            # hand the admission slot back before escaping, or the
            # throttle pins at its cap under sustained errors
            p.admitted = False
            self._admission.put(p.nbytes)
            raise

    def _wait(self, p: _PendingRead):
        try:
            if not p.event.wait(timeout=self.OP_TIMEOUT):
                raise TimeoutError(
                    f"read batcher flush of {p.nbytes} B {p.kind} timed "
                    f"out after {self.OP_TIMEOUT}s"
                )
            if p.error is not None:
                raise p.error
            return p.results
        finally:
            if p.admitted:
                p.admitted = False
                self._admission.put(p.nbytes)

    # -- inline fallback ---------------------------------------------------
    def _run_inline(self, p: _PendingRead) -> None:
        """Historical per-op path, on the submitting thread: a gather
        fans out alone, a decode is one solo pooled dispatch.  Also the
        recovery path for ops a flush failpoint erred out — bytes from
        here are the referee the batched path must match."""
        with self._lock:
            self._stats["inline"] += 1
        if self._logger is not None:
            self._logger.inc("read_batcher_inline")
        try:
            if p.kind == "gather":
                self._run_gathers([p])
            else:
                self._run_decodes([p])
        except Exception as e:
            p.error = e
        p.event.set()

    # -- flusher -----------------------------------------------------------
    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop_flag:
                    self._cond.wait(timeout=0.5)
                if not self._queue:
                    return  # stopped and drained
                self._wait_for_batch_locked()
                batch = self._queue
                self._queue = []
                self._queued_bytes = 0
                self._flush_asap = False
            try:
                self._flush_batch(batch)
            except Exception as e:  # belt: the flusher must never die
                if self._cct is not None:
                    self._cct.dout("osd", 0,
                                   f"{self._entity} read batcher flush "
                                   f"raised: {e!r}")
                self._complete(batch, err=e)

    def _wait_for_batch_locked(self) -> None:
        """Coalescing wait (lock held): returns once the batch should
        flush — caps reached, absolute window expired, an inter-arrival
        gap passed with no growth, or stop/flush_now."""
        window = self._window()
        max_ops = self._max_ops()
        max_bytes = self._max_bytes()
        first = self._queue[0].arrival
        gap = max(window / 8.0, 5e-5)
        while (
            not self._stop_flag
            and not self._flush_asap
            and len(self._queue) < max_ops
            and (max_bytes <= 0 or self._queued_bytes < max_bytes)
        ):
            remain = first + window - time.monotonic()
            if remain <= 0:
                break
            n0 = len(self._queue)
            self._cond.wait(timeout=min(remain, gap))
            if len(self._queue) == n0:
                break  # quiescent: every in-flight reader already queued

    def _flush_batch(self, batch: list[_PendingRead]) -> None:
        t0 = time.perf_counter()
        w0 = trace_now()
        for p in batch:
            if not p.queued_at:
                continue
            q_dur = max(0.0, w0 - p.queued_at)
            if p.acct is not None:
                tab, client, pool = p.acct
                tab.record_stage(client, pool, "queue", q_dur)
            if p.tracked is not None:
                p.tracked.stage_add("queue", q_dur)
            if p.tctx is not None:
                TRACER.record(p.tctx, "queue", entity=self._entity,
                              t0=p.queued_at, t1=w0)
        err: BaseException | None = None
        try:
            failpoint("osd.read_batcher.gather", cct=self._cct,
                      entity=self._entity, ops=len(batch))
        except FailpointCrash as e:
            # simulated death of the read plane: fail the batch and
            # latch coalescing off — later submits run inline
            with self._cond:
                self._crashed = True
            err = e
        except Exception as e:
            err = e
        if err is None:
            gathers = [p for p in batch if p.kind == "gather"]
            decodes = [p for p in batch if p.kind == "decode"]
            try:
                if gathers:
                    g0 = trace_now()
                    self._run_gathers(gathers)
                    if self._logger is not None:
                        self._logger.hinc("stage_read_gather",
                                          trace_now() - g0)
                if decodes:
                    d0 = trace_now()
                    self._run_decodes(decodes)
                    if self._logger is not None:
                        self._logger.hinc("stage_read_decode",
                                          trace_now() - d0)
            except Exception as e:
                err = e
        w1 = trace_now()
        if err is None:
            for p in batch:
                if p.tctx is not None:
                    TRACER.record(p.tctx, "read_flush",
                                  entity=self._entity, t0=w0, t1=w1,
                                  ops=len(batch))
        self._complete(batch, err=err)
        if err is None:
            nbytes = sum(p.nbytes for p in batch)
            with self._lock:
                self._stats["flushes"] += 1
                self._stats["ops"] += len(batch)
                self._stats["bytes"] += nbytes
            if self._logger is not None:
                self._logger.inc("read_batcher_flushes")
                self._logger.inc("read_batcher_ops", len(batch))
                self._logger.inc("read_batcher_bytes", nbytes)
                self._logger.tinc("read_batcher_flush_latency",
                                  time.perf_counter() - t0)

    # -- gather execution --------------------------------------------------
    def _run_gathers(self, gathers: list[_PendingRead]) -> None:
        """One sub-op fan-out for EVERY descriptor of every gather op:
        local reads served from the store, remote reads grouped by
        (pgid, shard, osd) into one multi-oid ``MECSubOpRead`` each,
        collected under one shared deadline."""
        io = self._io
        local = io.rb_local_osd()
        for p in gathers:
            p.results = {}
        # (pgid, shard, osd) -> (send rows, [(op, req index), ...])
        remote: dict[tuple, tuple[list, list]] = {}
        for p in gathers:
            for i, r in enumerate(p.reqs):
                osd = p.acting[r.shard] if r.shard < len(p.acting) else -1
                if osd == local:
                    p.results[i] = io.rb_read_local(
                        p.pgid, r.shard, r.oid, r.off, r.ln)
                    continue
                if osd < 0 or not io.rb_is_up(osd):
                    p.results[i] = None
                    continue
                rows, owners = remote.setdefault(
                    (p.pgid, r.shard, osd), ([], []))
                rows.append([r.oid, r.off, r.ln])
                owners.append((p, i))
        if not remote:
            return
        tids: dict[int, tuple] = {}
        epoch = io.rb_epoch()
        for (pgid, shard, osd), (rows, owners) in remote.items():
            tid = io.rb_send_multiread(osd, pgid, shard, rows, epoch)
            if tid is None:
                for p, i in owners:
                    p.results[i] = None
                continue
            tids[tid] = (pgid, shard, osd)
        with self._lock:
            self._stats["fanouts"] += len(tids)
        deadline = time.monotonic() + io.rb_reply_timeout()
        replies = io.rb_wait_multireads(set(tids), deadline)
        for tid, key in tids.items():
            _rows, owners = remote[key]
            rep = replies.get(tid)
            res = getattr(rep, "results", None) if rep is not None else None
            for j, (p, i) in enumerate(owners):
                row = res[j] if res is not None and j < len(res) else None
                if row is None or row[0] != 0:
                    p.results[i] = None
                else:
                    p.results[i] = (
                        unpack_data(row[1]),
                        row[3],
                        int(row[2]) if row[2] is not None else None,
                    )

    # -- decode execution --------------------------------------------------
    def _run_decodes(self, decodes: list[_PendingRead]) -> None:
        """One fused pack -> apply -> demux per decode-matrix group: one
        K1 launch on the card per group.  Stacks sharing a matrix concat
        along the column axis (variable widths are fine — demux walks
        cumulative offsets) into pinned staging, which commits into a
        pooled device buffer; the single fetch per group is the
        deliberate reply-serialization sync — decoded bytes go straight
        into a client reply, there is nothing downstream to keep
        device-resident for."""
        groups: dict[object, list[_PendingRead]] = {}
        for p in decodes:
            key = p.dm_key if p.dm_key is not None else p.dm.tobytes()
            groups.setdefault((key, p.stack.shape[0]), []).append(p)
        use_pool = self._use_pool()
        t0 = time.perf_counter()
        bytes_in = 0
        host_copy = 0
        for ps in groups.values():
            dm = ps[0].dm
            dev = commit([p.stack for p in ps], self._device, pooled=use_pool)
            bytes_in += dev.nbytes
            host_copy += dev.nbytes  # the pack into staging
            try:
                # the one deliberate read-plane sync
                out = apply_matrix(dm, dev, self._device, ps[0].dm_key).cpu().numpy()
            finally:
                if use_pool:
                    POOL.release(dev)
            host_copy += out.nbytes
            c = 0
            for p in ps:
                w = p.stack.shape[1]
                p.results = out[:, c:c + w]
                c += w
        with self._lock:
            self._stats["decode_groups"] += len(groups)
        if TELEMETRY.enabled:
            TELEMETRY.record(
                "read_batch_decode", current_backend(self._device),
                time.perf_counter() - t0, bytes_in=bytes_in,
                bytes_out=sum(int(p.results.nbytes) for p in decodes),
                synced=True, host_copy_bytes=host_copy)

    def _complete(self, batch: list[_PendingRead],
                  err: BaseException | None = None) -> None:
        for p in batch:
            if err is not None:
                p.error = err
            p.event.set()
