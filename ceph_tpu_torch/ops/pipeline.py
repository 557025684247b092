"""Host<->device pipelining for stripe-batch streams — counterpart of
ceph_tpu/ops/pipeline.py.

``stream_encode`` drives a sequence of host batches through the encode
kernel with at most two batches on the card: while K1 computes parity
for batch i on the compute stream (the caller's current stream), batch
i+1 is packed into a pinned staging buffer and copied on a copy stream
of its own; the fetch of result i-1 is the only host sync.

A copy from pageable host memory is synchronous, so overlap needs the
pinned staging of ``device_pool.commit``, whose blocks torch's caching
host allocator recycles (pinning memory per batch is slow).  The compute
stream waits on each batch's copy by an event; the batch's device buffer goes back
to ``POOL`` behind its kernel, and the pool orders its next use after
that kernel whatever stream reuses it.

The input is consumed as a true ITERATOR: a long stream holds at most
two input batches of host memory at any moment, never the whole stream.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.kernel_telemetry import TELEMETRY
from .bitplane import fused_encode
from .device_pool import POOL, commit


def stream_encode(mat: np.ndarray, batches, device=None,
                  mat_key: str | None = None) -> list[np.ndarray]:
    """Encode an iterable of host batches on `device` (``cuda`` unless
    ``device="cpu"``); returns the list of host parity arrays, one K1/K2
    launch per batch.  A batch is one [k, L] array, or a list of [k, L_i]
    arrays (a batcher's stripes) that its staging packs column-wise.

    `batches` may be any iterable, including a one-shot generator; it is
    pulled lazily, one batch ahead of the compute.  The device buffers
    come from the pool when it is on (``ec_device_pool``; a sentinel-
    degraded backend turns it off), else they are new.

    Telemetry: one `stream_encode` record per stream — the fetches make
    this a true sync point, so the record carries an honest achieved
    GiB/s for the whole double-buffered pipeline."""
    tm = TELEMETRY
    t_start = time.perf_counter() if tm.enabled else 0.0
    dev = resolve_device(device)
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    use_pool = POOL.enabled()
    cuda = dev.type == "cuda"
    compute = torch.cuda.current_stream(dev) if cuda else None
    copy = torch.cuda.Stream(dev) if cuda else None

    def upload(host):
        """Commit one batch on the copy stream; (device buffer, the
        event the compute stream waits on before reading it)."""
        with torch.cuda.stream(copy) if cuda else nullcontext():
            buf = commit(host if isinstance(host, list) else [host], dev,
                         pooled=use_pool)
            if not cuda:
                return buf, None
            done = torch.cuda.Event()
            done.record(copy)
        buf.record_stream(compute)  # read on the compute stream too
        return buf, done

    def fetch(parity: torch.Tensor) -> np.ndarray:
        # a copy even on the CPU: the buffer goes back to the pool
        host = parity.to("cpu", copy=True).numpy()
        if use_pool:
            POOL.release(parity)  # dead device buffer: recycle
        return host

    it = iter(batches)
    first = next(it, None)
    if first is None:
        return []
    outs = []
    bytes_in = 0
    pending = None  # device result of the previous batch, not yet fetched
    nxt = upload(first)
    while nxt is not None:
        buf, done = nxt
        bytes_in += buf.nbytes
        if done is not None:
            compute.wait_event(done)
        # launch compute first (async), THEN start the next copy so the
        # copy engine and the SMs overlap
        out = POOL.empty((mat.shape[0], buf.shape[1]), device=dev) if use_pool else None
        res = fused_encode(mat, [buf], dev, mat_key, out=out)
        if use_pool:
            POOL.release(buf)  # behind its kernel on the compute stream
        upcoming = next(it, None)
        nxt = upload(upcoming) if upcoming is not None else None
        if pending is not None:
            outs.append(fetch(pending))  # keeps two batches live
        pending = res
    outs.append(fetch(pending))
    if tm.enabled:
        bytes_out = sum(int(o.nbytes) for o in outs)
        tm.record("stream_encode", dev.type, time.perf_counter() - t_start,
                  bytes_in=bytes_in, bytes_out=bytes_out, synced=True,
                  host_copy_bytes=bytes_in + bytes_out)
    return outs
