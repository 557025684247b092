"""Geometry-keyed pools of stripe buffers — counterpart of
ceph_tpu/ops/device_pool.py.

``POOL`` keeps dead device buffers (a fetched parity block, a consumed
stripe pack) on free lists for the next use of the same geometry:

- ``put(host_array)`` commits a host array to the device through the
  pool: a free buffer of its geometry is refilled in place
  (``dst.copy_(src, non_blocking=True)``, where the reference donated
  the buffer to a jitted copy, ``_refill``), else a fresh one is made.
- ``acquire(shape)`` pops a free buffer (``fused_encode_async`` takes
  its parity output so); ``release(buf)`` returns one.
- Free lists are keyed by geometry ``(shape, dtype, device)`` and
  bounded by ``ec_device_pool_max_bytes``, with least-recently-USED
  geometry eviction.

The reference asks its backend whether donation recycles anything (XLA
ignores it on the CPU).  A refill in place recycles on every device, so
the port has no such question and the CPU tests run the card's path.

Reuse across threads and streams.  The free lists bypass torch's
stream-aware caching allocator, and a buffer is often released on one
thread (an op's commit fetch) while work queued by another (the
flusher's K1) may still read it, or released by a stream other than the
one that reuses it (``stream_encode``'s copy stream).  So ``release``
records a CUDA event on the stream of the buffer's last use, and
``acquire`` makes the current stream wait on that event before the
buffer is handed out: a wait on the device, never on the host.

Staging.  A copy from pageable host memory is synchronous, so
``commit`` packs host arrays into pinned host memory first.  Pinned
buffers come from torch's caching host allocator (``torch.empty(...,
pin_memory=True)``), a pool of their own: a freed block is reused for
any request of its size class (a power of two) once the copies that
read it are done, so ``cudaHostAlloc`` runs only while the pool warms
up.  (Keyed by exact geometry, as POOL is, a flush of 9 stripes could
not reuse the staging of a flush of 8, and every such miss pinned new
memory.)

Stats (hits/misses/evictions/donations/puts/releases) are authoritative
here and mirrored into the kernel telemetry's ``device_pool_*``
series.  ``enabled()`` is sentinel-aware: a latched
degraded backend turns the pool off; the work stays on the card.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.kernel_telemetry import SENTINEL, TELEMETRY
from ..common.lockdep import make_lock


def _geom(shape, dtype: torch.dtype, device: torch.device) -> tuple:
    if device.type == "cuda" and device.index is None:
        # "cuda" as asked for names the buffer's "cuda:<current>"
        device = torch.device("cuda", torch.cuda.current_device())
    return (tuple(int(d) for d in shape), str(dtype), str(device))


def _last_use(buf: torch.Tensor, stream) -> torch.cuda.Event | None:
    """An event after the work queued so far on `stream` (the stream of
    the buffer's last use; its device's current stream by default).  None
    for a CPU buffer, which no stream touches."""
    if not buf.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(stream if stream is not None else torch.cuda.current_stream(buf.device))
    return ev


class DevicePool:
    """Bounded geometry-keyed free lists of device buffers (see module
    docstring).  Process-wide singleton ``POOL`` below; thread-safe."""

    def __init__(self, max_bytes: int = 256 << 20, enabled: bool = True):
        self._lock = make_lock("ops::device_pool")
        self._max_bytes = int(max_bytes)
        self._enabled = bool(enabled)
        #: geometry -> [(buffer, event of its last use)]; OrderedDict
        #: order IS the LRU order (move_to_end on every touch)
        self._free: OrderedDict[tuple, list] = OrderedDict()
        self._resident = 0
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "donations": 0, "puts": 0, "releases": 0}

    # -- config ------------------------------------------------------------
    def configure(self, enabled: bool | None = None,
                  max_bytes: int | None = None) -> None:
        """Apply the ec_device_pool / ec_device_pool_max_bytes options."""
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
                if not self._enabled:
                    self._drain_locked()
            if max_bytes is not None:
                self._max_bytes = int(max_bytes)
            self._evict_locked()

    def enabled(self) -> bool:
        """Pool usable right now: configured on AND the backend sentinel
        has not latched degraded."""
        return self._enabled and not SENTINEL.is_degraded

    @property
    def max_bytes(self) -> int:
        return self._max_bytes

    # -- the free-list cycle -----------------------------------------------
    def acquire(self, shape, dtype: torch.dtype = torch.uint8,
                device=None) -> torch.Tensor | None:
        """Pop a free buffer of exactly this geometry (None = miss), ready
        for use on the current stream.  Stats count the hit or miss."""
        key = _geom(shape, dtype, resolve_device(device))
        ent = None
        with self._lock:
            bufs = self._free.get(key)
            if bufs:
                self._free.move_to_end(key)
                ent = bufs.pop()
                if not bufs:
                    self._free.pop(key, None)
                self._resident -= ent[0].nbytes
                self._stats["hits"] += 1
                resident = self._resident
            else:
                self._stats["misses"] += 1
        if ent is None:
            TELEMETRY.record_pool(misses=1)
            return None
        buf, ev = ent
        if ev is not None:
            torch.cuda.current_stream(buf.device).wait_event(ev)
        TELEMETRY.record_pool(hits=1, resident_bytes=resident)
        return buf

    def release(self, buf: torch.Tensor | None, stream=None) -> None:
        """Return a dead buffer to its geometry's free list, usable once
        the work queued on `stream` (its last use; by default the current
        stream of a device buffer) is done.  Bounded: least-recently-used
        geometries evict past max_bytes."""
        if buf is None or not self._enabled:
            return
        key = _geom(buf.shape, buf.dtype, buf.device)
        ent = (buf, _last_use(buf, stream))
        with self._lock:
            if not self._enabled:
                return
            self._free.setdefault(key, []).append(ent)
            self._free.move_to_end(key)
            self._resident += buf.nbytes
            self._stats["releases"] += 1
            dropped = self._evict_locked()
            resident = self._resident
        TELEMETRY.record_pool(evictions=dropped, resident_bytes=resident)

    def empty(self, shape, dtype: torch.dtype = torch.uint8,
              device=None) -> torch.Tensor:
        """A buffer of this geometry: a recycled one when the pool is on
        and has one, else a new one."""
        buf = self.acquire(shape, dtype, device) if self.enabled() else None
        if buf is not None:
            return buf
        return torch.empty(shape, dtype=dtype, device=resolve_device(device))

    def put(self, host, device=None) -> torch.Tensor:
        """Commit one host array (numpy, or a CPU tensor) to `device`
        through the pool: a free same-geometry buffer is refilled in place,
        else a new one is filled.  The copy is asynchronous when `host`
        is pinned; the caller keeps it alive until the copy is done."""
        if isinstance(host, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(host))
        with self._lock:
            self._stats["puts"] += 1
        buf = self.acquire(host.shape, host.dtype, device) \
            if self.enabled() else None
        if buf is not None:
            with self._lock:
                self._stats["donations"] += 1
            TELEMETRY.record_pool(donations=1)
        else:
            buf = torch.empty(host.shape, dtype=host.dtype,
                              device=resolve_device(device))
        return buf.copy_(host, non_blocking=True)

    # -- bookkeeping -------------------------------------------------------
    def _evict_locked(self) -> int:
        dropped = 0
        while self._resident > self._max_bytes and self._free:
            _key, ents = self._free.popitem(last=False)  # LRU geometry
            for buf, _ev in ents:
                self._resident -= buf.nbytes
            dropped += len(ents)
        self._stats["evictions"] += dropped
        return dropped

    def _drain_locked(self) -> None:
        self._free.clear()
        self._resident = 0

    def clear(self) -> None:
        """Drop every pooled buffer (tests; backend resets)."""
        with self._lock:
            self._drain_locked()
        TELEMETRY.record_pool(resident_bytes=0)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["resident_bytes"] = self._resident
            out["geometries"] = len(self._free)
            out["max_bytes"] = self._max_bytes
            out["enabled"] = self._enabled
        return out


#: the device pool; the write batcher and the read batcher re-read
#: ``ec_device_pool`` per flush, so the option works at run time
POOL = DevicePool()


def commit(parts, device=None, pooled: bool = True) -> torch.Tensor:
    """Host arrays [rows, L_i] -> one [rows, sum L_i] uint8 buffer on
    `device`, packed column-wise into a staging buffer (pinned on the
    card) and copied from it without a host wait on the current stream,
    into a POOL buffer (a new buffer when `pooled` is False).  The
    staging buffer is dropped at once: torch's host allocator reuses its
    block only after the copy."""
    dev = resolve_device(device)
    parts = [np.asarray(p, dtype=np.uint8) for p in parts]
    shape = (parts[0].shape[0], sum(p.shape[1] for p in parts))
    stage = torch.empty(shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    np.concatenate(parts, axis=1, out=stage.numpy())
    if pooled:
        return POOL.put(stage, dev)
    return torch.empty(shape, dtype=torch.uint8, device=dev).copy_(stage, non_blocking=True)
