#!/usr/bin/env python3
"""Where the OSD batchers' time goes on one card: chip_smoke.py's phases
18, 19 and 21 under cProfile and under torch.profiler.

    python3 port_runs/batcher_profile.py                (repo root; one GPU)
    python3 port_runs/batcher_profile.py --root DIR     (the package in DIR)

RS(8,4) cauchy_good, 256 client threads, 1 MiB objects as [8, 131072]
stripes made on the card from a seed: the write batcher at the option
defaults with the device pool on and off, one 256-stripe burst flushed at
once, and the read batcher's degraded read (shards 1, 4, 9, 11 lost)
through an in-memory adapter without the wire's base64 (so the flusher's
profile shows the batcher, not the adapter).  Each scenario runs twice
plain (cold, warm), for its wall time, per-op p50/p99, flushes and K1
launches; then under cProfile, which in Python 3.12 sees every thread
(the flusher's and the clients'), for the most expensive functions by
own time; then under torch.profiler, for the card's busy time (the union
of its kernels and copies in the trace, build/batcher_profile/) and its
idle share of that run's wall time.  Last, the cost of pinned host
memory: a cold and a warm 256 MiB ``torch.empty(..., pin_memory=True)``,
copies of 256 MiB to the card from pageable and from pinned memory, and
the write batcher's per-op copies out of a flush's parity on the host
(256 column windows of [4, 131072] into new arrays, and into arrays
touched before) from pinned and from pageable memory.  `--root` imports
``ceph_tpu_torch`` from DIR instead (an unpacked other version, for
turns in one call).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
OBJECTS, OBJECT_BYTES, SEED = 256, 1 << 20, 20261017
LOST = (1, 4, 9, 11)


def clients(n: int, op) -> tuple[np.ndarray, float]:
    lat = np.zeros(n)

    def go(i: int) -> None:
        t0 = time.perf_counter()
        op(i)
        lat[i] = time.perf_counter() - t0

    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return lat, time.perf_counter() - t0


class LocalShards:
    """rb_* adapter: every shard local to OSD 0's store, lost ones absent."""

    def __init__(self, shards):
        self.shards = shards

    def rb_local_osd(self):
        return 0

    def rb_is_up(self, osd):
        return True

    def rb_read_local(self, pgid, shard, oid, off, ln):
        b = self.shards.get((shard, oid))
        return None if b is None else (b, 1, len(b))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ec.stripe import StripeInfo
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.device_pool import POOL
    from ceph_tpu_torch.osd.read_batcher import ReadBatcher, ReadReq
    from ceph_tpu_torch.osd.write_batcher import WriteBatcher

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card {torch.cuda.get_device_name(0)}; {smi}; package {args.root}", flush=True)
    rs84 = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "technique": "cauchy_good", "k": "8", "m": "4"})
    mat, key = rs84.coding, rs84.bitplane.coding_digest
    si = StripeInfo(k=8, stripe_unit=4096)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    objects = torch.randint(0, 256, (OBJECTS, OBJECT_BYTES), dtype=torch.uint8,
                            device="cuda", generator=g)
    xs = list(torch.stack([si.shard_layout(o) for o in objects]).cpu().numpy())
    gf_kernels.library()

    profiles: dict[str, cProfile.Profile] = {}

    def flusher_profiled(cls, name: str):
        orig = cls._flush_loop

        def loop(self):
            prof = profiles.setdefault(name, cProfile.Profile())
            prof.enable()
            try:
                orig(self)
            finally:
                prof.disable()
        cls._flush_loop = loop
        return orig

    def report(name: str, lat, wall, stats, launches) -> None:
        print(f"[{name}] wall {wall * 1e3:.1f} ms, per op p50 {np.percentile(lat, 50) * 1e3:.2f}"
              f" ms p99 {np.percentile(lat, 99) * 1e3:.2f} ms; {stats}; K1 launches {launches}",
              flush=True)

    def write(overrides: dict, burst: bool):
        wb = WriteBatcher(CephContext("osd.0", overrides=overrides), entity="osd.0")
        wb.start()
        k0 = gf_kernels.LAUNCHES["gf_apply_k1"]
        try:
            if burst:
                tickets = [wb.encode_submit(mat, x, key) for x in xs]
                t0 = time.perf_counter()
                wb.flush_now()
                for t in tickets:
                    wb.encode_wait(t)
                wall = time.perf_counter() - t0
                lat = np.array([wall])
            else:
                lat, wall = clients(OBJECTS, lambda i: wb.encode_chunks(mat, xs[i], key))
        finally:
            wb.stop()
        return lat, wall, wb.stats(), gf_kernels.LAUNCHES["gf_apply_k1"] - k0

    avail = [j for j in range(12) if j not in LOST]
    shards = {}
    for o, x in enumerate(xs):
        full = np.vstack([x, rs84.bitplane.encode(x).cpu().numpy()])
        for j in avail:
            shards[(j, f"obj{o}")] = full[j].tobytes()
    dm, dm_key = rs84.bitplane._decode_entry(tuple(avail))

    def read(overrides: dict):
        rb = ReadBatcher(CephContext("osd.0", overrides=overrides), io=LocalShards(shards),
                         entity="osd.0")
        rb.start()
        k0 = gf_kernels.LAUNCHES["gf_apply_k1"]

        def op(o: int) -> None:
            res = rb.gather("1.0", [0] * 12, [ReadReq(j, f"obj{o}") for j in avail],
                            est_bytes=8 * xs[0].shape[1])
            rb.decode(dm, np.stack([np.frombuffer(res[i][0], np.uint8) for i in range(8)]),
                      dm_key)
        try:
            lat, wall = clients(OBJECTS, op)
        finally:
            rb.stop()
        return lat, wall, rb.stats(), gf_kernels.LAUNCHES["gf_apply_k1"] - k0

    burst_conf = {"ec_batch_window_ms": 10_000.0, "ec_batch_max_stripes": 10_000,
                  "ec_batch_max_bytes": 1 << 30}
    scenarios = [
        ("18 write, pool on", WriteBatcher, lambda: write({}, False)),
        ("18 write, pool off", WriteBatcher, lambda: write({"ec_device_pool": False}, False)),
        ("19 burst of 256", WriteBatcher, lambda: write(burst_conf, True)),
        ("21 degraded read", ReadBatcher, lambda: read({})),
    ]
    from remap_profile import busy_us  # the same union of device intervals

    trace_dir = ROOT / "build" / "batcher_profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for n, (name, cls, run) in enumerate(scenarios):
        for rep in ("cold", "warm"):
            report(f"{name}, {rep}", *run())
        orig = flusher_profiled(cls, name)
        try:
            report(f"{name}, profiled", *run())
        finally:
            cls._flush_loop = orig
        buf = io.StringIO()
        st = pstats.Stats(profiles[name], stream=buf)
        print(f"[{name}] profiled threads' time {st.total_tt * 1e3:.1f} ms", flush=True)
        st.sort_stats("tottime").print_stats(14)
        print("\n".join(buf.getvalue().splitlines()[6:]), flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lat, wall, stats, launches = run()
            torch.cuda.synchronize()
        trace = trace_dir / f"scenario_{n}.json"
        prof.export_chrome_trace(str(trace))
        busy = busy_us(trace) / 1e3
        print(f"[{name}] under torch.profiler: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.4f}", flush=True)
    print(f"[pool] {POOL.stats()}", flush=True)

    # the cost of pinned host memory and of the copies from it
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
        print(f"[pinned] torch.empty 256 MiB pin_memory=True, {label}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        del pinned
    pageable = np.concatenate(xs, axis=1).reshape(-1)
    pinned = torch.empty(pageable.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = pageable
    dst = torch.empty(pageable.shape, dtype=torch.uint8, device="cuda")
    for label, src in (("pageable", torch.from_numpy(pageable)), ("pinned", pinned)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
        print(f"[copy] 256 MiB host to device from {label}: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    S = xs[0].shape[1]
    landing = torch.empty((4, OBJECTS * S), dtype=torch.uint8, pin_memory=True)
    landing.fill_(1)
    for label, full in (("pinned", landing.numpy()), ("pageable", np.ones_like(landing.numpy()))):
        t0 = time.perf_counter()
        outs = [full[:, i * S:(i + 1) * S].copy() for i in range(OBJECTS)]
        fresh = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, o in enumerate(outs):
            np.copyto(o, full[:, i * S:(i + 1) * S])
        touched = time.perf_counter() - t0
        print(f"[copy] 256 windows of [4, {S}] out of {label} memory: into new arrays "
              f"{fresh * 1e3:.1f} ms, into arrays touched before {touched * 1e3:.1f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
