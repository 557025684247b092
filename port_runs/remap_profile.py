#!/usr/bin/env python3
"""Where the 10M-object remap's time goes, by torch.profiler, on one card.

    python3 port_runs/remap_profile.py          (from the repo root; one GPU)

Maps x = 0..9,999,999 through rule 0 (3 replicas) of the 128 hosts x 8
OSDs map, with every OSD in and then with host 17's eight OSDs out, each
under torch.profiler (CPU and CUDA activities).  For each it prints the
wall time, the K3 launches, the device's busy time (the union of the
intervals of its kernels, copies and memsets in the trace), the device's
idle share of the wall time (1 - busy / wall), and the ten operators
with the most device time.  The traces (tens of MB each) go to
build/remap_profile/remap_<label>.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map  # noqa: E402
from ceph_tpu_torch.ops import crush_kernels  # noqa: E402


def busy_us(trace: Path) -> float:
    """Union of the device intervals (kernels, copies, memsets) of a trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.loads(trace.read_text())
                   ["traceEvents"] if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("remap_profile: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    w = CrushWrapper(build_hierarchical_map(128, 8))
    xs = torch.arange(10_000_000, dtype=torch.int32, device="cuda")
    weights = np.full(1024, 0x10000)
    out = weights.copy()
    out[17 * 8:18 * 8] = 0
    for wv in (weights, out):  # warm up the allocator and the kernels
        w.do_rule_batch(0, xs, 3, wv)
    trace_dir = ROOT / "build" / "remap_profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for label, wv in (("all_in", weights), ("host17_out", out)):
        crush_kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            w.do_rule_batch(0, xs, 3, wv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace = trace_dir / f"remap_{label}.json"
        prof.export_chrome_trace(str(trace))
        busy = busy_us(trace) / 1e6
        print(f"{label}: wall {wall:.4f} s, K3 launches "
              f"{crush_kernels.LAUNCHES['crush_straw2_k3']}, device busy {busy:.4f} s, "
              f"idle share {1 - busy / wall:.4f}")
        events = [e for e in prof.key_averages() if device_us(e) > 0]
        for e in sorted(events, key=device_us, reverse=True)[:10]:
            print(f"    {device_us(e) / 1e3:10.3f} ms device  {e.count:6d} calls  "
                  f"{e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
