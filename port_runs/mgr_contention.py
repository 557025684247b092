#!/usr/bin/env python3
"""How long the mgr's batched placement takes inside a running cluster.

    python3 port_runs/mgr_contention.py [--device cpu] [--osds 12]
                                        [--switch-ms 5,0.5] [--turns 2]

Starts a port LocalCluster with the mgr hosted (one monitor, --osds OSDs,
the mgr's default modules; `cuda` unless --device cpu), creates phase
31's pools of chip_smoke.py (an RS(8,4) pool of pg_num 64 and a size-3
pool of pg_num 128), waits until both are clean, and then maps each pool
with OSDMap.map_pool on the driver's thread, in turns at each of the
interpreter switch intervals given (milliseconds), --turns times.  Then
the same map alone, with the cluster stopped.  Every OSD's threads (a
reader per connection among them) share one interpreter lock with the
caller: each draw's host syncs and its launch give the lock up and wait
to get it back.  Prints one line per call: interval, pool, seconds,
crush_straw2_k3 launches (0 on the CPU, where K3's plain version runs).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.ops import crush_kernels  # noqa: E402
from ceph_tpu_torch.osd import OSDMap  # noqa: E402
from ceph_tpu_torch.qa import LocalCluster  # noqa: E402

POOLS = (("rs84", 64), ("rep3", 128))


def timed(m: OSDMap, pid: int) -> tuple[float, int]:
    import torch

    k0 = crush_kernels.LAUNCHES["crush_straw2_k3"]
    t0 = time.perf_counter()
    m.map_pool(pid)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, crush_kernels.LAUNCHES["crush_straw2_k3"] - k0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--osds", type=int, default=12)
    ap.add_argument("--switch-ms", default="5,0.5")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    switches = [float(s) for s in args.switch_ms.split(",")]
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    default = sys.getswitchinterval()
    c = LocalCluster(n_mons=1, n_osds=args.osds, with_mgr=True, device=args.device,
                     conf_overrides={"mgr_balancer_interval": 3600.0})
    c.start()
    try:
        c.create_ec_pool("rs84", k=8, m=4, pg_num=POOLS[0][1], plugin="torch",
                         extra_profile={"technique": "cauchy_good"})
        c.create_replicated_pool("rep3", size=3, pg_num=POOLS[1][1])
        for name, _n in POOLS:
            c.wait_clean(name, timeout=600)
        blob = c._leader().osdmon.osdmap.to_json()
        m = OSDMap.from_json(blob, device=args.device)
        pids = {p.name: pid for pid, p in m.pools.items()}
        timed(m, pids["rs84"])  # first call: compiled map, kernels loaded
        for _ in range(args.turns):
            for ms in switches:
                sys.setswitchinterval(ms / 1e3)
                for name, _n in POOLS:
                    s, n = timed(m, pids[name])
                    print(f"in the cluster, switch {ms} ms: {name} {s:.3f} s, {n} K3 launches",
                          flush=True)
    finally:
        sys.setswitchinterval(default)
        c.stop()
    for name, _n in POOLS:
        s, n = timed(m, pids[name])
        print(f"alone, switch {default * 1e3:g} ms: {name} {s:.3f} s, {n} K3 launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
