"""WriteBatcher — the coalescing encode layer in front of the GF codec;
the port's counterpart of ceph_tpu/osd/write_batcher.py
(ROADMAP "Batched async write path end-to-end"; arXiv:1709.05365's
finding that online-EC system throughput is dominated by the queueing/
batching structure in FRONT of the codec, not the codec itself).

Every EC client write used to walk the stack alone and hand the codec a
single [k, L] stripe; the TPU kernel only earns its throughput when
stripes arrive in fat batches.  The batcher aggregates concurrent
encode requests into multi-stripe batches and performs ONE fused
pack -> apply_matrix -> scatter per flush, one K1 launch on the card:

    op A  [k, L] ─┐
    op B  [k, L] ─┼─ concat ─> [k, B*L] ── K1 (ops/bitplane.py) ──> [m, B*L]
    op C  [k, L] ─┘                                   │
          ^ per-op parity slices demuxed back ────────┘

GF matrix application is byte-column-local (the same property the RMW
parity delta rests on), so the fused parity bytes are BIT-IDENTICAL to
the per-op path — batching changes scheduling, never results.  Each op
blocks for its own slice, so ack/ordering/rollback semantics upstream
(version assignment, sub-op fan-out, dup detection) are untouched.

Flush policy is NIC-interrupt-coalescing shaped, two timers + caps:

- size/byte caps (``ec_batch_max_stripes`` / ``ec_batch_max_bytes``)
  flush immediately when reached;
- an ABSOLUTE window (``ec_batch_window_ms``) bounds how long the
  batch's first stripe may wait;
- an INTER-ARRIVAL gap (window/8) flushes as soon as the queue stops
  growing — closed-loop writers (every in-flight op already queued)
  flush at once instead of idling out the window, while open-load
  bursts still accumulate fat batches.

Backpressure: admission into the batcher rides a ``Throttle``
(common/throttle.py) capped at a few windows of queue bytes.  A full
queue blocks the submitting op thread BEFORE it queues more work; the
blocked op holds its slot in the client's ``objecter_inflight_ops`` /
``objecter_inflight_op_bytes`` admission window, so sustained overload
propagates all the way back and new client writes block at admission,
not mid-pipeline.

A flush larger than ``ec_batch_max_bytes`` (shutdown drains, bursty
arrivals) is split on stripe boundaries and streamed through
``ops.pipeline.stream_encode`` so host->device DMA of device-batch i+1
overlaps the kernel computing device-batch i.

The batcher runs on ``device`` (``cuda`` unless ``device="cpu"``; without
a card it raises).  At its boundary it keeps the reference's host
contract, numpy in and numpy out (parity goes to the object store);
inside, the apply, the pool and the fetch are on the device.

cephdma — the fully async encode path: with the device stripe pool on
(``ec_device_pool``, default; ``ops/device_pool.py``) a flush packs its
stripes into a pinned staging buffer, commits them with one
asynchronous copy into a pooled device buffer and launches K1 into a
pooled parity buffer (``bitplane.fused_encode_async``); the flusher then
starts the parity's copy to pinned host memory and completes WITHOUT
waiting for it — the single deliberate sync is each op's
``encode_wait`` (the commit point), where the first op of the flush
waits for that copy and returns the parity buffer to the pool.
Kernel telemetry separates the two seams: ``ec_batch_flush`` carries
the flush's host-copy bytes (pool ON: transfers only; OFF: pack +
transfer + fetch — the control the ci_gate compares), ``encode_wait``
carries the commit-point sync bytes.  The pool is bypassed — the
historical synchronous path, still K1 on the card — when
``ec_device_pool=false`` or the backend sentinel has latched degraded.

Fault injection: the ``osd.write_batcher.flush`` failpoint fires at the
head of every flush.  ``error`` fails EVERY op in the batch (none acks
— the thrasher's no-acked-write-loss invariant holds because the
clients see the failure); ``delay(s)`` stalls the flush; ``crash``
additionally latches the batcher off, after which submits fall back to
inline per-op encode (K1 on the card, one launch per op).  A failed
build or launch fails the batch like ``error``; nothing retries on the
CPU or on the kernel's plain version.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.failpoint import FailpointCrash, failpoint
from ..common.kernel_telemetry import TELEMETRY
from ..common.lockdep import make_lock
from ..common.throttle import Throttle
from ..common.tracer import TRACER, kernel_annotation, op_trace, trace_now
from ..ops.bitplane import apply_matrix, current_backend, fused_encode_async
from ..ops.device_pool import POOL
from ..ops.pipeline import stream_encode


class _FlushRef:
    """One pooled flush's device-resident parity: the fused [m, B*L]
    parent buffer plus the shared commit state.  The FIRST op to reach
    its encode_wait materializes the whole parent in ONE fetch (a
    single sync + host copy per flush, not per stripe), caches the host
    array for its batch-mates, and returns the parent buffer to the
    device pool."""

    #: bound on waiting out another op's in-flight fetch
    FETCH_TIMEOUT = 60.0

    __slots__ = ("parent", "host", "error", "fetch_bytes", "_claim",
                 "_ready", "_landing", "_landed")

    def __init__(self, parent: torch.Tensor):
        self.parent = parent
        self.host: np.ndarray | None = None
        self.error: BaseException | None = None
        self.fetch_bytes = 0  # set once, by the fetching op
        self._claim = make_lock("osd::wb_flush_ref")
        self._ready = threading.Event()
        # start the device->host transfer WITHOUT blocking (the flusher
        # builds this BEFORE completing the batch, so no op can have
        # consumed the parent yet): the copy into pinned host memory is
        # queued behind K1 on the flusher's stream, and the elected
        # fetcher only waits for it to land (the event; None on the
        # CPU, where the copy is synchronous).  Each op copies its own
        # window out (_commit_fetch), so the pinned block goes back to
        # torch's host cache once the flush's last op has committed
        cuda = parent.is_cuda
        self._landing = torch.empty(parent.shape, dtype=parent.dtype,
                                    pin_memory=cuda)
        self._landing.copy_(parent, non_blocking=cuda)
        self._landed: torch.cuda.Event | None = None
        if cuda:
            self._landed = torch.cuda.Event()
            self._landed.record(torch.cuda.current_stream(parent.device))

    def fetch(self) -> tuple[np.ndarray, bool]:
        """The commit-point materialization: ONE op is elected to fetch
        and everyone else waits on a broadcast Event — batch-mates wake
        in a burst, not a lock-handoff trickle (the trickle was measured
        to starve the NEXT flush's coalescing window).  A fetch failure
        (the async path surfaces deferred device errors HERE) is latched
        and re-raised to every batch-mate.  Returns (host parity of the
        whole flush, did-I-pay-for-the-fetch)."""
        if self.host is None and self.error is None \
                and self._claim.acquire(blocking=False):
            try:
                if self.host is None and self.error is None:
                    # parent is only ever touched by the thread holding
                    # _claim (the try-acquire above)
                    dev, self.parent = self.parent, None
                    try:
                        if self._landed is not None:
                            self._landed.synchronize()  # THE commit-point sync
                        host = self._landing.numpy()
                    except BaseException as e:
                        self.error = e
                        self._ready.set()
                        raise
                    self.fetch_bytes = host.nbytes
                    self.host = host
                    # broadcast BEFORE the pool bookkeeping: 63 batch-
                    # mates may be parked on this event
                    self._ready.set()
                    POOL.release(dev)
                    return host, True
            finally:
                self._claim.release()
        if self.host is None and self.error is None \
                and not self._ready.wait(self.FETCH_TIMEOUT):
            raise TimeoutError("flush parity fetch never completed")
        if self.error is not None:
            raise self.error
        return self.host, False


class _DevParity:
    """A stripe's parity still resident on device (the pooled async
    path): column window [c0, c1) of its flush's fused parity,
    materialized host-side only at the op's encode_wait."""

    __slots__ = ("ref", "c0", "c1", "rows")

    def __init__(self, ref: _FlushRef, c0: int, c1: int, rows: int):
        self.ref = ref
        self.c0 = c0
        self.c1 = c1
        self.rows = rows

    @property
    def nbytes(self) -> int:
        return self.rows * (self.c1 - self.c0)


class _PendingStripe:
    """One op's stripe riding a batch: input chunks in, parity (or the
    batch's error) out.  Completion rides a PER-OP Event rather than the
    batcher's shared condition: a notify_all on a shared condition wakes
    every waiter on every arrival AND every completion (a thundering
    herd that was measured to eat the whole batching win at 8+ clients),
    while an Event wakes exactly its own op.  The Event's internal lock
    is the publish edge ordering the flusher's parity write before the
    submitter's read."""

    __slots__ = ("key", "mat", "mat_key", "chunks", "nbytes", "arrival",
                 "event", "parity", "error", "admitted", "tctx",
                 "tracked", "acct", "queued_at", "share_key")

    def __init__(self, mat: np.ndarray, chunks: np.ndarray,
                 mat_key: str | None = None):
        self.mat = mat
        # stable digest of mat held on the codec (cephdma satellite: no
        # fresh mat.tobytes() host copy per stripe to key the group)
        self.mat_key = mat_key
        self.chunks = chunks
        # fuse only stripes encoding under the same matrix at the same
        # chunk length: concat along columns is exact for those
        self.key = (mat_key if mat_key is not None else mat.tobytes(),
                    chunks.shape[1])
        self.nbytes = chunks.nbytes
        self.arrival = time.monotonic()
        self.event = threading.Event()
        self.parity: np.ndarray | None = None
        self.error: BaseException | None = None
        self.admitted = False  # holds admission-throttle budget
        # cephtrace: the submitting op's context rides the stripe so the
        # flusher (a different thread) can attribute queue/encode spans
        self.tctx = None
        self.tracked = None
        # cephmeter: (table, client, pool) identity the OSD stamped into
        # the op-trace state — per-client admission/queue attribution
        self.acct = None
        self.queued_at = 0.0  # trace_now clock, for the queue-stage span
        # cephqos: (client, pool) whose per-client admission share this
        # stripe's bytes count against (None = identity-less submit)
        self.share_key = None


class WriteBatcher:
    """Multi-stripe encode coalescer (see module docstring).

    ``encode_chunks(mat, chunks)`` is the one entry point: [k, L] byte
    chunks in, [m, L] parity out, blocking until the op's batch flushed.
    Callers that are not plain column-local matrix applies must not come
    here (the OSD's ``_batch_matrix`` eligibility gate).
    """

    #: admission throttle holds this many byte-caps of queued stripes
    QUEUE_WINDOWS = 4
    #: ceiling on one op's wait for admission into a saturated queue
    ADMIT_TIMEOUT = 30.0
    #: ceiling on one op's wait for its flush (window + device time)
    OP_TIMEOUT = 60.0

    def __init__(self, cct, logger=None, entity: str = "", device=None):
        self._cct = cct
        #: where the applies run: ``cuda`` unless ``device="cpu"``
        self._device = resolve_device(device)
        self._logger = logger
        self._entity = entity or (cct.name if cct is not None else "")
        self._lock = make_lock("osd::write_batcher")
        self._cond = threading.Condition(self._lock)
        self._queue: list[_PendingStripe] = []
        self._queued_bytes = 0
        self._flush_asap = False
        self._stop_flag = False
        self._crashed = False
        self._thread: threading.Thread | None = None
        self._admission = Throttle(
            "write_batcher::queue",
            self._max_bytes() * self.QUEUE_WINDOWS,
        )
        # own counters so standalone users (bench) see stats without a
        # PerfCounters registry; the OSD's logger mirrors them
        # device_batches: the applies the flushes issued (one per group,
        # one per stream_encode batch of an oversize group) — on the card
        # each is one K1 launch
        self._stats = {"flushes": 0, "stripes": 0, "bytes": 0, "inline": 0,
                       "share_waits": 0, "device_batches": 0}
        # cephqos: admission bytes currently held per (client, pool) —
        # the per-client share gate reads/writes this under self._lock;
        # _share_waiters counts gate sleepers so releases only notify
        # when someone is actually parked (a no-waiter notify is noise
        # to the flusher and to cephrace's lost-wakeup heuristic)
        self._held: dict[tuple, int] = {}
        self._share_waiters = 0
        # fan-in tag tying one fused encode's many per-op spans together;
        # touched only by the single flusher thread
        self._flush_seq = 0

    def _release_share(self, p: _PendingStripe) -> None:
        """Return one stripe's bytes to its client's admission share and
        wake share-gate waiters (idempotent via share_key clearing)."""
        key = p.share_key
        if key is None:
            return
        p.share_key = None
        with self._cond:
            left = self._held.get(key, 0) - p.nbytes
            if left > 0:
                self._held[key] = left
            else:
                self._held.pop(key, None)
            if self._share_waiters:
                self._cond.notify_all()

    # -- config (runtime-changeable: read per use) -------------------------
    def _window(self) -> float:
        if self._cct is None:
            return 0.0
        return max(0.0, float(self._cct.conf.get("ec_batch_window_ms"))) / 1e3

    def _max_stripes(self) -> int:
        if self._cct is None:
            return 1
        return max(1, int(self._cct.conf.get("ec_batch_max_stripes")))

    def _max_bytes(self) -> int:
        if self._cct is None:
            return 0
        return max(0, int(self._cct.conf.get("ec_batch_max_bytes")))

    def _client_share(self, cap: int) -> int:
        """Per-(client,pool) admission-share cap in bytes (cephqos);
        0 = disabled (no cct, unbounded queue, or share >= 1.0)."""
        if self._cct is None or cap <= 0:
            return 0
        frac = float(self._cct.conf.get("ec_batch_client_max_share"))
        if frac >= 1.0:
            return 0
        return max(1, int(cap * frac))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cond:
            if self._thread is not None:
                return
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._flush_loop,
                name=f"{self._entity}-wb-flush", daemon=True,
            )
        self._thread.start()

    def stop(self) -> None:
        """Drain-and-stop: queued stripes are flushed (shutdown flush),
        then the flusher exits; later submits encode inline."""
        with self._cond:
            self._stop_flag = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    def coalescing(self) -> bool:
        """True when submits will be batched rather than encoded inline."""
        with self._lock:
            return (self._thread is not None and not self._stop_flag
                    and not self._crashed) and self._window() > 0.0

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
        """Pooled async flush path usable right now: the runtime escape
        hatch (``ec_device_pool``) AND the process-wide pool's own gate
        (configured on, sentinel not degraded)."""
        if self._cct is not None \
                and not bool(self._cct.conf.get("ec_device_pool")):
            return False
        return POOL.enabled()

    # -- submit ------------------------------------------------------------
    def encode_chunks(self, mat: np.ndarray, chunks: np.ndarray,
                      mat_key: str | None = None) -> np.ndarray:
        """[k, L] data chunks -> [m, L] parity, bit-identical to
        ``apply_matrix(mat, chunks)``; blocks until this stripe's
        batch flushed (or encodes inline when coalescing is off)."""
        return self.encode_wait(self.encode_submit(mat, chunks, mat_key))

    def encode_submit(self, mat: np.ndarray, chunks: np.ndarray,
                      mat_key: str | None = None) -> _PendingStripe:
        """Queue one [k, L] stripe for coalesced encode and return its
        ticket.  Every ticket MUST be passed to encode_wait (it holds
        admission-throttle budget until then).  Async clients keep a
        small window of tickets in flight — that window is what lets a
        single writer's stripes coalesce with its own, not only with
        other writers'.  ``mat_key``: the codec's precomputed stable
        digest of ``mat`` (ops.bitplane.matrix_digest) — group keying
        and the device operand cache then skip the per-stripe
        ``mat.tobytes()`` host copy."""
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        p = _PendingStripe(mat, chunks, mat_key)
        st = op_trace()
        if st is not None:
            if TRACER.enabled:  # one attribute check when tracing is off
                p.tctx = st.get("ctx")
            p.tracked = st.get("tracked")
            p.acct = st.get("acct")
        if not self.coalescing():
            p.parity = self._inline(mat, chunks, tctx=p.tctx,
                                    tracked=p.tracked, mat_key=mat_key)
            p.event.set()
            return p
        # backpressure: block HERE, at admission, while the queue is
        # saturated — the op thread's inflight budget upstream is what
        # carries the stall back to the client's admission throttle
        cap = self._max_bytes() * self.QUEUE_WINDOWS
        if cap != self._admission.max:
            self._admission.reset_max(cap)
        t_adm0 = trace_now()
        # cephqos per-client share gate BEFORE the global FIFO: one bulk
        # streamer's bytes cap out at share*cap, so a small writer's
        # stripe never queues behind a wall of someone else's budget.
        # An op past its own share waits for its OWN earlier bytes to
        # drain (at least one stripe always fits — no self-deadlock);
        # stop/crash pass the gate and take the inline path below.
        share = self._client_share(cap)
        key = tuple(p.acct[1:]) if p.acct is not None else None
        if share > 0 and key is not None:
            with self._cond:
                if self._held.get(key, 0) + p.nbytes > max(share, p.nbytes):
                    self._stats["share_waits"] += 1
                    self._share_waiters += 1
                    try:
                        ok = self._cond.wait_for(
                            lambda: (self._stop_flag or self._crashed
                                     or self._held.get(key, 0) + p.nbytes
                                     <= max(share, p.nbytes)),
                            timeout=self.ADMIT_TIMEOUT)
                    finally:
                        self._share_waiters -= 1
                    if not ok:
                        raise IOError(
                            f"write batcher per-client share timed out "
                            f"({self._held.get(key, 0)} B held by {key}, "
                            f"share {share} B)")
                # reserve inside the critical section (two threads of
                # one client must not both pass the check unreserved);
                # released by encode_wait, or below on admission timeout
                self._held[key] = self._held.get(key, 0) + p.nbytes
            p.share_key = key
        if not self._admission.get(p.nbytes, timeout=self.ADMIT_TIMEOUT):
            self._release_share(p)
            raise IOError(
                f"write batcher admission timed out "
                f"({self._admission.current} B queued, cap {cap} B)"
            )
        p.admitted = True
        try:
            t_adm1 = trace_now()
            if self._logger is not None:
                self._logger.hinc("stage_admission", t_adm1 - t_adm0)
            if p.acct is not None:
                tab, client, pool = p.acct
                tab.record_stage(client, pool, "admission",
                                 t_adm1 - t_adm0)
            if p.tracked is not None:
                p.tracked.stage_add("admission", t_adm1 - t_adm0)
            if p.tctx is not None:
                TRACER.record(p.tctx, "admission", entity=self._entity,
                              t0=t_adm0, t1=t_adm1, nbytes=p.nbytes)
                if p.tracked is not None:
                    p.tracked.mark_event("admission", ts=t_adm1)
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
            if not enqueued:  # raced a stop/crash: encode inline
                p.parity = self._inline(p.mat, p.chunks, tctx=p.tctx,
                                        tracked=p.tracked,
                                        mat_key=p.mat_key)
                p.event.set()
            return p
        except Exception:
            # nobody will encode_wait() a ticket whose submit raised —
            # hand the admission slot and share back before escaping,
            # or the throttle pins at its cap under sustained errors
            p.admitted = False
            self._admission.put(p.nbytes)
            self._release_share(p)
            raise

    def encode_wait(self, p: _PendingStripe) -> np.ndarray:
        """Block for a ticket's parity (or raise its batch's error).

        THE commit point of the async encode path: a pooled flush left
        this op's parity device-resident, and the wait for its copy here
        is the one deliberate host materialization — per op, off the
        flusher thread, accounted as the ``encode_wait`` sync-point
        kernel record.  The last stripe of a flush to commit returns the
        flush's parity buffer to the device pool."""
        try:
            if not p.event.wait(timeout=self.OP_TIMEOUT):
                raise TimeoutError(
                    f"write batcher flush of {p.nbytes} B stripe timed "
                    f"out after {self.OP_TIMEOUT}s"
                )
            if p.tracked is not None:
                # dump_historic_ops offset for the encode stage, same
                # trace_now clock the flusher's span boundaries use
                p.tracked.mark_event("encode", ts=trace_now())
            if p.error is not None:
                raise p.error
            if isinstance(p.parity, _DevParity):
                p.parity = self._commit_fetch(p.parity)
            return p.parity
        finally:
            if p.admitted:
                p.admitted = False
                self._admission.put(p.nbytes)
            self._release_share(p)

    def _commit_fetch(self, dp: _DevParity) -> np.ndarray:
        """Materialize one op's device-resident parity (the deliberate
        commit sync): the flush's shared fetch runs at most once; this
        op then copies its own column window out of the pinned landing
        buffer."""
        t0 = time.perf_counter()
        full, fetched = dp.ref.fetch()
        if fetched and TELEMETRY.enabled:
            # ONE record per flush, by the op that paid the fetch — its
            # batch-mates' waits are free host slices, and recording
            # each of them was measured to cost real throughput at
            # 10k+ ops/s (the counters lock per record)
            TELEMETRY.record(
                "encode_wait", current_backend(self._device),
                time.perf_counter() - t0,
                bytes_out=dp.ref.fetch_bytes, synced=True,
                host_copy_bytes=dp.ref.fetch_bytes)
        return full[:, dp.c0:dp.c1].copy()

    def _inline(self, mat: np.ndarray, chunks: np.ndarray,
                tctx=None, tracked=None,
                mat_key: str | None = None) -> np.ndarray:
        with self._lock:
            self._stats["inline"] += 1
        if self._logger is not None:
            self._logger.inc("ec_batch_inline")
        t0 = trace_now()
        with kernel_annotation(
            "ec_encode_inline", (tctx.trace_id,) if tctx is not None else ()
        ):
            # inline per-op encode is deliberately synchronous
            parity = apply_matrix(mat, chunks, self._device, mat_key).cpu().numpy()
        if tctx is not None:
            TRACER.record(tctx, "encode", entity=self._entity,
                          t0=t0, t1=trace_now(), inline=True)
        if tracked is not None:
            tracked.stage_add("encode", trace_now() - t0)
        if self._logger is not None:
            self._logger.hinc("stage_encode", trace_now() - t0)
        return parity

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
                                   f"{self._entity} write batcher flush "
                                   f"raised: {e!r}")
                self._complete(batch, err=e)

    def _wait_for_batch_locked(self) -> None:
        """Coalescing wait (lock held): returns once the batch should
        flush — caps reached, absolute window expired, an inter-arrival
        gap passed with no growth, or stop/flush_now."""
        window = self._window()
        max_stripes = self._max_stripes()
        max_bytes = self._max_bytes()
        first = self._queue[0].arrival
        gap = max(window / 8.0, 5e-5)
        while (
            not self._stop_flag
            and not self._flush_asap
            and len(self._queue) < max_stripes
            and (max_bytes <= 0 or self._queued_bytes < max_bytes)
        ):
            remain = first + window - time.monotonic()
            if remain <= 0:
                break
            n0 = len(self._queue)
            self._cond.wait(timeout=min(remain, gap))
            if len(self._queue) == n0:
                break  # quiescent: every in-flight writer already queued

    def _flush_batch(self, batch: list[_PendingStripe]) -> None:
        t0 = time.perf_counter()
        w0 = trace_now()
        traced = [p for p in batch if p.tctx is not None]
        # queue stage: stripe admitted -> flush started
        for p in batch:
            if not p.queued_at:
                continue
            q_dur = max(0.0, w0 - p.queued_at)
            if self._logger is not None:
                self._logger.hinc("stage_queue", q_dur)
            if p.acct is not None:
                tab, client, pool = p.acct
                tab.record_stage(client, pool, "queue", q_dur)
            if p.tracked is not None:
                p.tracked.stage_add("queue", q_dur)
        for p in traced:
            TRACER.record(p.tctx, "queue", entity=self._entity,
                          t0=p.queued_at or w0, t1=w0)
        err: BaseException | None = None
        try:
            failpoint("osd.write_batcher.flush", cct=self._cct,
                      entity=self._entity, stripes=len(batch))
        except FailpointCrash as e:
            # simulated death of the encode stage: fail the batch and
            # latch coalescing off — later submits encode inline
            with self._cond:
                self._crashed = True
            err = e
        except Exception as e:
            err = e
        results: list[tuple[_PendingStripe, object]] = []
        host_copy = 0
        flush_synced = False
        if err is None:
            try:
                results, host_copy, flush_synced = \
                    self._encode_groups(batch)
            except Exception as e:
                err = e
        w1 = trace_now()
        if err is None:
            for p in batch:
                if p.tracked is not None:
                    p.tracked.stage_add("encode", w1 - w0)
        if err is None and traced:
            # ONE fused-encode flush, MANY op spans: the fan-in is
            # expressed as one "encode" span per participating trace
            # (parent = that op's ctx, so every tree stays connected)
            # all sharing a flush_id + fan_in tag
            with self._lock:
                self._flush_seq += 1
                fid = self._flush_seq
            fan_in = len({p.tctx.trace_id for p in traced})
            seen: set[str] = set()
            for p in traced:
                if p.tctx.trace_id in seen:
                    continue  # one op may batch several stripes
                seen.add(p.tctx.trace_id)
                TRACER.record(
                    p.tctx, "encode", entity=self._entity, t0=w0, t1=w1,
                    flush_id=fid, stripes=len(batch), fan_in=fan_in,
                )
        self._complete(batch, err=err, results=results)
        if err is None:
            nbytes = sum(p.nbytes for p in batch)
            with self._lock:
                self._stats["flushes"] += 1
                self._stats["stripes"] += len(batch)
                self._stats["bytes"] += nbytes
            if self._logger is not None:
                self._logger.inc("ec_batch_flushes")
                self._logger.inc("ec_batch_stripes", len(batch))
                self._logger.inc("ec_batch_bytes", nbytes)
                self._logger.tinc("ec_batch_flush_latency",
                                  time.perf_counter() - t0)
                self._logger.hinc("stage_encode", w1 - w0)
            if TELEMETRY.enabled:
                # pool OFF: the flush fetched every parity slice, a
                # true sync point — honest achieved GiB/s for the fused
                # pack -> encode -> scatter.  Pool ON: dispatch is
                # async (synced=False, the record measures the queue;
                # the commit-point sync rides the per-op `encode_wait`
                # record instead), and host_copy carries only the
                # copies THIS flush actually performed — the
                # control-vs-pool delta the ci_gate smoke compares.
                TELEMETRY.record(
                    "ec_batch_flush", current_backend(self._device),
                    time.perf_counter() - t0, bytes_in=nbytes,
                    bytes_out=sum(int(r[1].nbytes) for r in results),
                    synced=flush_synced, host_copy_bytes=host_copy)

    def _encode_groups(
        self, batch: list[_PendingStripe]
    ) -> tuple[list[tuple[_PendingStripe, object]], int, bool]:
        """One fused pack -> encode -> scatter per (matrix, L) group: one
        K1 launch on the card per group, or per device batch of a group
        split through ``stream_encode``.

        Returns (results, host_copy_bytes, synced): with the device pool
        ON the results are `_DevParity` slices still resident on device
        (nothing waited for — host_copy counts the host->device stripe
        commits and synced stays False, the dispatch is async); with it
        OFF this is the historical synchronous path (host pack copy +
        transfer + full parity fetch, all counted, synced True).  Parity
        bytes are bit-identical either way — pooling changes scheduling
        and allocation, never results."""
        groups: dict[tuple, list[_PendingStripe]] = {}
        for p in batch:
            groups.setdefault(p.key, []).append(p)
        max_bytes = self._max_bytes()
        use_pool = self._use_pool()
        dev = self._device
        host_copy = 0
        synced = False
        applies = 0
        out: list[tuple[_PendingStripe, object]] = []
        for (_gkey, L), ps in groups.items():
            mat = ps[0].mat
            stripe_b = ps[0].chunks.nbytes
            group_b = sum(p.chunks.nbytes for p in ps)
            if max_bytes > 0 and len(ps) > 1 and group_b > max_bytes:
                # burst bigger than one device batch: split on stripe
                # boundaries and double-buffer DMA against compute
                # (stream_encode packs each device batch into its own
                # staging and counts those copies; its result fetches
                # make this group a sync point either way)
                spd = max(1, max_bytes // stripe_b)
                outs = stream_encode(
                    mat, ([p.chunks for p in ps[i:i + spd]]
                          for i in range(0, len(ps), spd)),
                    dev, mat_key=ps[0].mat_key)
                applies += len(outs)
                synced = True
                for i, p in enumerate(ps):
                    b, j = divmod(i, spd)
                    out.append((p, outs[b][:, j * L:(j + 1) * L]))
                continue
            applies += 1
            if use_pool:
                # cephdma pooled async path: the stripes commit through
                # pinned staging into a pooled buffer and K1 writes a
                # pooled parity buffer, all queued without a wait; the
                # op's encode_wait owns the single deliberate sync, and
                # the parent parity buffer recycles through the pool there
                parity_dev = fused_encode_async(
                    mat, [p.chunks for p in ps], dev, mat_key=ps[0].mat_key)
                host_copy += group_b  # the host->device stripe commit
                ref = _FlushRef(parity_dev)
                m_rows = mat.shape[0]
                for i, p in enumerate(ps):
                    out.append((p, _DevParity(
                        ref, i * L, (i + 1) * L, m_rows)))
                continue
            # historical synchronous path (ec_device_pool=false escape
            # hatch / sentinel-degraded backend): host pack, transfer,
            # full parity fetch right here on the flusher
            packed = (ps[0].chunks if len(ps) == 1 else
                      np.concatenate([p.chunks for p in ps], axis=1))
            # the pool-off flush IS the sync point
            parity = apply_matrix(mat, packed, dev, ps[0].mat_key).cpu().numpy()
            host_copy += (packed.nbytes if len(ps) > 1 else 0) \
                + packed.nbytes + parity.nbytes
            synced = True
            for i, p in enumerate(ps):
                out.append((p, parity[:, i * L:(i + 1) * L]))
        with self._lock:
            self._stats["device_batches"] += applies
        return out, host_copy, synced

    def _complete(self, batch: list[_PendingStripe],
                  err: BaseException | None = None,
                  results: list[tuple[_PendingStripe, object]] = ()):
        if err is not None:
            for p in batch:
                p.error = err
                p.event.set()
        else:
            for p, parity in results:
                p.parity = parity
                p.event.set()
