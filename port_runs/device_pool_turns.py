#!/usr/bin/env python3
"""The device pool's flush against the pool-off flush on one card, in
turns: qa/device_pool_smoke.py's scenario (bench/traffic.py run_traffic,
batched, 4 clients x 4 writes in flight of 4 KiB RS(8,4) stripes, 2 s
after 0.75 s of warm-up), control, pool, pool, control, for `--pairs`
rounds (with --copy the second pool run copies each op's parity out of
its flush's landed block, as the port did before its commit returned a
view); then each mode once under cProfile (every thread in Python
3.12), its most expensive functions by own time; then, with --stages,
each mode once with the write batcher's stages timed by wrappers (the
flush's wait for its batch, the first and last stripe's queue time, the
encode, the async parity's landing setup, the completion, each op's
wait for its flush and its commit fetch), medians and sums in ms.

    python3 port_runs/device_pool_turns.py [--pairs 3] [--copy] [--stages] [--device cuda]

Each line gives the mode's GiB/s, flushes, stripes a flush and host-copy
bytes a flush (the ec_batch_flush record the smoke's gates read).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def flush_record() -> dict:
    from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY

    ks = TELEMETRY.dump().get("ec_batch_flush", {})
    return {k: ks.get(k, 0) for k in ("calls", "host_copy_bytes", "sync_points")}


def run(pool_on: bool, device, copy: bool = False) -> dict:
    """One run of the smoke's scenario; `copy` makes each op's commit
    copy its window out of its flush's landed parity (the port's commit
    before it returned a view, as the reference's does)."""
    from ceph_tpu_torch.bench.traffic import run_traffic
    from ceph_tpu_torch.osd import write_batcher as wb

    view_commit = wb.WriteBatcher._commit_fetch
    if copy:
        def copy_commit(self, dp):
            return view_commit(self, dp).copy()
        wb.WriteBatcher._commit_fetch = copy_commit

    before = flush_record()
    try:
        res = run_traffic("batched", n_clients=4, seconds=2.0, write_size=4096, k=8, m=4,
                          qd=4, warmup=0.75, conf_overrides={"ec_device_pool": pool_on},
                          device=device)
    finally:
        wb.WriteBatcher._commit_fetch = view_commit
    after = flush_record()
    flushes = max(1, after["calls"] - before["calls"])
    return {"mode": ("pool, copy" if copy else "pool") if pool_on else "control",
            "gibps": res["gibps"],
            "ops": res["ops"], "flushes": after["calls"] - before["calls"],
            "stripes_per_flush": res["stripes_per_flush"],
            "host_copy_per_flush": (after["host_copy_bytes"] - before["host_copy_bytes"])
            / flushes, "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"]}


def staged(pool_on: bool, device) -> None:
    """One run with the write batcher's stages timed (see the module
    docstring); prints each stage's count, median and sum in ms."""
    import collections
    import time

    import numpy as np

    from ceph_tpu_torch.osd import write_batcher as wb

    times: dict[str, list[float]] = collections.defaultdict(list)
    saved = {}

    def timed(owner, name: str, label: str, pre=None):
        fn = getattr(owner, name)
        saved[(owner, name)] = fn

        def wrapper(*a, **kw):
            if pre is not None:
                pre(*a)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[label].append(time.perf_counter() - t0)
        setattr(owner, name, wrapper)

    def queued(self, batch):
        now = time.monotonic()
        times["queue, first stripe"].append(now - batch[0].arrival)
        times["queue, last stripe"].append(now - batch[-1].arrival)
        times["stripes a flush"].append(len(batch) * 1e-3)

    timed(wb.WriteBatcher, "_wait_for_batch_locked", "flusher: wait for the batch")
    timed(wb.WriteBatcher, "_flush_batch", "flusher: flush", pre=queued)
    timed(wb.WriteBatcher, "_encode_groups", "flusher: encode groups")
    timed(wb.WriteBatcher, "_complete", "flusher: complete the ops")
    timed(wb._FlushRef, "__init__", "flusher: parity landing setup")
    timed(wb._FlushRef, "fetch", "op: flush fetch")
    timed(wb.WriteBatcher, "_commit_fetch", "op: commit fetch")
    timed(wb.WriteBatcher, "encode_wait", "op: encode_wait")
    timed(wb.WriteBatcher, "encode_submit", "op: encode_submit")
    try:
        res = run(pool_on, device)
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
    print(f"[stages {res['mode']}] {res}", flush=True)
    for label, v in times.items():
        a = np.asarray(v) * 1e3
        print(f"    {label}: n {len(a)}, median {np.median(a):.4f}, sum {a.sum():.1f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--copy", action="store_true",
                    help="turns of control, pool, pool with copied commits, control")
    args = ap.parse_args()
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(f"card: {smi}", flush=True)
    from ceph_tpu_torch.ops import gf_kernels

    if args.device == "cuda":
        gf_kernels.library()
    for i in range(args.pairs):
        modes = (((False, False), (True, False), (True, True), (False, False)) if args.copy
                 else ((False, False), (True, False), (True, False), (False, False)))
        for pool_on, copy in modes:
            print(f"[turn {i}] {run(pool_on, args.device, copy)}", flush=True)
    if args.stages:
        for pool_on in (False, True, True, False):
            staged(pool_on, args.device)
    for pool_on in (False, True):
        prof = cProfile.Profile()
        prof.enable()
        res = run(pool_on, args.device)
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.top)
        print(f"[cProfile {res['mode']}] {res}", flush=True)
        print("\n".join(out.getvalue().splitlines()[:args.top + 12]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
