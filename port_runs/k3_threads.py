#!/usr/bin/env python3
"""K3's device time at each thread count a lane, at the main path's
launch shapes, on one card.

    python3 port_runs/k3_threads.py      (from the repo root; one GPU)

On the 128-host x 8-OSD map (BASELINE config 5's 1024 OSDs), for 5,592,405
lanes (one pass of the 10M-object remap's interpreter), 32768 and 8192
lanes (OSDMap.map_pool's two pools of chip_smoke.py), the root draw (128
slots) and the host draw that follows it (8 slots): K3's device time at
the host's choice of T (``crush_kernels.threads_per_lane``) and at every T
from 1 to 32, with the map's magic, timed as chip_smoke.py's ``time_ms``
does (CUDA events, the stream held until every call is enqueued); each
result is first checked equal to the plain version.  Prints one JSON line
per shape and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map  # noqa: E402
from ceph_tpu_torch.ops import crush_kernels as ck  # noqa: E402

LANES = (5_592_405, 32768, 8192)


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cm = CrushWrapper(build_hierarchical_map(128, 8)).compiled(dev)
    magic = (cm.magic_m, cm.magic_ka)
    sms = ck.sm_count(dev)
    for lanes in LANES:
        xs = torch.arange(lanes, dtype=torch.int32, device=dev)
        zeros = torch.zeros_like(xs)
        root_args = (cm.items, cm.weights, cm.sizes, zeros, xs, zeros, zeros)
        hosts = (-1 - ck.straw2_choose(*root_args, magic=magic)).contiguous()
        host_args = (cm.items, cm.weights, cm.sizes, hosts, xs, zeros, zeros)
        for level, args in (("root", root_args), ("host", host_args)):
            want = ck.straw2_choose_plain(*args)
            row = {"lanes": lanes, "level": level,
                   "host_T": ck.threads_per_lane(lanes, cm.items.shape[1], sms)}
            for T in cs.K3_THREADS:
                got = ck.straw2_choose(*args, magic=magic, threads=T)
                cs.check(torch.equal(got, want), f"K3 at T={T} differs at {lanes} {level}")
                row[f"T{T}_ms"], _ = cs.time_ms(
                    torch, lambda: ck.straw2_choose(*args, magic=magic, threads=T), iters=10)
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
