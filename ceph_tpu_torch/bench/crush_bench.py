"""CRUSH mapping benchmark CLI — BASELINE.json config 5 (the port's
counterpart of ceph_tpu/bench/crush_bench.py).

The analog of `crushtool --test` timing runs (reference:
src/tools/crushtool.cc + src/crush/CrushTester.cc) over a large x batch:
maps N placement inputs through a rule on the batch mapper (K3 on the
card, ``--device cuda``, the default) and on the C++ oracle (the
compiled-C mapper baseline, on the host), reporting maps/s.  With
``--backend both`` the oracle maps a batch capped at 1M xs and the whole
of it is compared with the same prefix of the batch mapper's output.

Usage:
    python -m ceph_tpu_torch.bench.crush_bench --osds 1024 --hosts 128 \
        --num-pgs 10000000 --numrep 3 [--backend torch|oracle|both] \
        [--device cpu] [--json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: the oracle's batch is capped here; --backend both compares all of it
ORACLE_CAP = 1_000_000


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ceph_tpu_torch.bench.crush_bench")
    p.add_argument("--osds", type=int, default=1024)
    p.add_argument("--hosts", type=int, default=128)
    p.add_argument("--num-pgs", type=int, default=1_000_000, dest="num_pgs")
    p.add_argument("--numrep", type=int, default=3)
    p.add_argument("--rule", type=int, default=0, help="0=firstn replicated, 1=indep EC")
    p.add_argument("--backend", choices=["torch", "oracle", "both"], default="both")
    p.add_argument("--device", default="cuda",
                   help="the batch mapper's device (default: cuda; cpu on request)")
    p.add_argument("--json", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..common.device import resolve_device
    from ..crush import CompiledCrushMap, build_hierarchical_map, crush_do_rule_batch

    dev = resolve_device(args.device)
    if args.osds % args.hosts:
        raise SystemExit("--osds must be divisible by --hosts")
    cmap = build_hierarchical_map(args.hosts, args.osds // args.hosts)
    weights = np.full(args.osds, 0x10000, dtype=np.uint32)
    xs = np.arange(args.num_pgs, dtype=np.int64)
    res: dict = {
        "osds": args.osds,
        "hosts": args.hosts,
        "num_pgs": args.num_pgs,
        "numrep": args.numrep,
        "rule": args.rule,
        "device": str(dev),
    }

    out = None
    if args.backend in ("torch", "both"):
        import torch

        cm = CompiledCrushMap(cmap, device=dev)
        warm = crush_do_rule_batch(cm, args.rule, xs[:1024], args.numrep, weights)
        warm.cpu()  # build + sync
        t0 = time.perf_counter()
        out = crush_do_rule_batch(cm, args.rule, xs, args.numrep, weights)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        out = out.cpu().numpy()
        res["torch_maps_per_s"] = round(args.num_pgs / dt)
        res["torch_seconds"] = round(dt, 4)
        res["sample"] = out[:2].tolist()

    if args.backend in ("oracle", "both"):
        from ..crush.oracle_bridge import do_rule_batch_oracle

        n = min(args.num_pgs, ORACLE_CAP)  # oracle baseline on a capped batch
        t0 = time.perf_counter()
        out_o = do_rule_batch_oracle(cmap, args.rule, xs[:n], args.numrep, weights)
        dt = time.perf_counter() - t0
        res["oracle_maps_per_s"] = round(n / dt)
        res["oracle_seconds"] = round(dt, 4)
        if out is not None:
            res["oracle_compared"] = n
            res["bit_exact_vs_oracle"] = bool(np.array_equal(out_o, out[:n]))

    if "torch_maps_per_s" in res and "oracle_maps_per_s" in res:
        res["speedup"] = round(res["torch_maps_per_s"] / res["oracle_maps_per_s"], 2)
    print(json.dumps(res) if args.json else res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
