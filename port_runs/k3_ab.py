#!/usr/bin/env python3
"""Placement end to end, another checkout of the port against this one,
in turns on one card.

    python3 port_runs/k3_ab.py --other DIR [--pairs N]   (from the repo root; one GPU)

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into a directory .gitignore lists).  The
script runs one child process per turn, in the order other, this, this,
other, N times over (``--pairs``, 1 by default); each imports ``ceph_tpu_torch`` from its own checkout (and builds
its kernels there) and times, on the 128-host x 8-OSD map (BASELINE
config 5's 1024 OSDs):

- the 10M-object remap of rule 0 (3 replicas) with every OSD in: the
  first pass, then the median of three warm passes; and one pass with
  host 17's eight OSDs out;
- ``OSDMap.map_pool`` of a 32768-PG size-3 pool and an 8192-PG RS(8,4)
  size-12 pool (median of 5 passes each), and each pool's K3 launches a
  pass;
- K3 at each pool's root draw (its placement seeds in the root bucket):
  the device time (CUDA events, the stream held by torch.cuda._sleep until
  every call is enqueued, as chip_smoke.py's ``time_ms``) and the host time
  of one ``straw2_choose`` call as the mapper makes it.

Each turn prints one JSON line; the whole goes to chiprun_out/k3_ab.json
beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REMAP_OBJECTS = 10_000_000
HOSTS, OSDS_PER_HOST, OUT_HOST = 128, 8, 17
#: pool id -> (pg_num, size, rule): chip_smoke.py's phase 22 pools
POOLS = {1: (32768, 3, 0), 2: (8192, 12, 1)}


def _smoke():
    """This checkout's chip_smoke.py, for its time_ms."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import ceph_tpu_torch
    from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map
    from ceph_tpu_torch.ops import crush_kernels as ck
    from ceph_tpu_torch.osd import PG_POOL_ERASURE, OSDMap

    assert Path(ceph_tpu_torch.__file__).resolve().is_relative_to(root.resolve())
    time_ms = _smoke().time_ms
    dev = torch.device("cuda")
    ck.library()
    res = {"root": str(root)}

    def sync_s(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    w = CrushWrapper(build_hierarchical_map(HOSTS, OSDS_PER_HOST))
    weights = np.full(HOSTS * OSDS_PER_HOST, 0x10000, dtype=np.int64)
    xs = torch.arange(REMAP_OBJECTS, dtype=torch.int32, device=dev)
    res["remap_first_s"] = sync_s(lambda: w.do_rule_batch(0, xs, 3, weights))
    res["remap_warm_s"] = float(np.median(
        [sync_s(lambda: w.do_rule_batch(0, xs, 3, weights)) for _ in range(3)]))
    out = weights.copy()
    out[OUT_HOST * OSDS_PER_HOST:(OUT_HOST + 1) * OSDS_PER_HOST] = 0
    res["remap_out_s"] = sync_s(lambda: w.do_rule_batch(0, xs, 3, out))
    del xs

    m = OSDMap(w, device=dev)
    for pid, (pg_num, size, rule) in POOLS.items():
        m.create_pool(pid, pg_num=pg_num, size=size, crush_rule=rule,
                      **({"type": PG_POOL_ERASURE} if size == 12 else {}))
    cm = w.compiled(dev)
    takes_magic = "magic" in inspect.signature(ck.straw2_choose).parameters
    for pid, (pg_num, _, _) in POOLS.items():
        m.map_pool(pid)
        k0 = ck.LAUNCHES["crush_straw2_k3"]
        m.map_pool(pid)
        res[f"pool{pid}_launches"] = ck.LAUNCHES["crush_straw2_k3"] - k0
        res[f"pool{pid}_map_pool_ms"] = 1e3 * float(np.median(
            [sync_s(lambda: m.map_pool(pid)) for _ in range(5)]))
        pps = torch.from_numpy(m.pools[pid].raw_pg_to_pps_batch(
            np.arange(pg_num)).astype(np.int32)).to(dev)
        zeros = torch.zeros_like(pps)
        args = (cm.items, cm.weights, cm.sizes, zeros, pps, zeros, zeros)
        kw = {"magic": (cm.magic_m, cm.magic_ka)} if takes_magic else {}
        res[f"pool{pid}_k3_root_ms"], res[f"pool{pid}_k3_root_host_ms"] = time_ms(
            torch, lambda: ck.straw2_choose(*args, **kw), iters=20)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the checkout to compare with")
    ap.add_argument("--pairs", type=int, default=1,
                    help="rounds of the turns other, this, this, other")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    turns = []
    other = a.other.resolve()
    order = (("other", other), ("this", ROOT), ("this", ROOT), ("other", other))
    for label, root in order * a.pairs:
        proc = subprocess.run([sys.executable, __file__, "--child", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        turn = {"turn": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_ab.json").write_text(json.dumps({"card": smi, "turns": turns}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
