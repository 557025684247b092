#!/usr/bin/env python3
"""K1 and the write batcher, another checkout of the port against this
one, in turns on one card.

    python3 port_runs/k1_ab.py --other DIR [--pairs N]   (from the repo root; one GPU)

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into a directory .gitignore lists).  The
script runs one child process per turn, in the order other, this, this,
other, N times over (``--pairs``, 1 by default); each imports
``ceph_tpu_torch`` from its own checkout (and builds its kernels there)
and, on RS(8,4) cauchy_good as chip_smoke.py drives it:

- times K1 at five launch shapes, each checked byte for byte against
  ``apply_matrix_plain`` first: phase 3's ragged [4, 8] x 3000, the EC
  path's 256 stripes of [8, 131072] (phase 9), the write batcher's packed
  [8, 33554432] flush (phase 19), a 4 MiB object's encode [4, 8] x 524288
  and degraded decode [8, 8] x 524288 (phases 25, 26 and 29).  For each,
  the staged launch (``gf_kernels.prepare``) and the whole wrapper
  (``gf_apply``): device time (CUDA events, the stream held by
  torch.cuda._sleep until every call is enqueued, as chip_smoke.py's
  ``time_ms``) and host time a call;
- runs phase 18's write batcher at the option defaults (device pool on)
  with 256 client threads on 1 MiB [8, 131072] host stripes: per-op p50
  and p99 and the wall time;
- runs phase 19's 256-stripe burst in one flush: ``flush_now`` to the
  last commit.

Every parity is checked against ``apply_matrix_plain`` on the card.  Each
turn prints one JSON line; the whole goes to chiprun_out/k1_ab.json beside
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261017
OBJECTS, STRIPE = 256, 131072   # 1 MiB RS(8,4) objects as [8, 131072] stripes
CLUSTER_COLS = 524288           # a 4 MiB object's RS(8,4) stripe
LOST = (1, 4, 9, 11)


def _smoke():
    """This checkout's chip_smoke.py, for its time_ms and run_clients."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import ceph_tpu_torch
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import gf_kernels as gk
    from ceph_tpu_torch.ops.bitplane import TABLES
    from ceph_tpu_torch.osd.write_batcher import WriteBatcher

    assert Path(ceph_tpu_torch.__file__).resolve().is_relative_to(root.resolve())
    smoke = _smoke()
    dev = torch.device("cuda")
    gk.library()
    rs = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "technique": "cauchy_good", "k": "8", "m": "4"})
    coding, key = rs.coding, rs.bitplane.coding_digest
    dm, _ = rs.bitplane._decode_entry(tuple(j for j in range(12) if j not in LOST))
    g = torch.Generator(device=dev)

    def rand(shape, seed: int):
        g.manual_seed(SEED + seed)
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)

    res = {"root": str(root)}
    rows = {
        "ragged": (coding, [rand((8, 3000), 3)]),
        "ec_path": (coding, [rand((8, STRIPE), 100 + i) for i in range(OBJECTS)]),
        "flush": (coding, [rand((8, OBJECTS * STRIPE), 19)]),
        "cluster_write": (coding, [rand((8, CLUSTER_COLS), 25)]),
        "cluster_read": (dm, [rand((8, CLUSTER_COLS), 26)]),
    }
    for name, (mat, segs) in rows.items():
        tables = TABLES.get(mat, dev)
        got = gk.gf_apply(mat, segs, tables=tables)
        want = gk.apply_matrix_plain(mat, torch.cat(segs, dim=1))
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"K1 at {name} differs from the plain version"
        res[f"{name}_ms"], res[f"{name}_host_ms"] = smoke.time_ms(
            torch, gk.prepare(mat, segs, tables), iters=20)
        res[f"{name}_wrapper_ms"], res[f"{name}_wrapper_host_ms"] = smoke.time_ms(
            torch, lambda: gk.gf_apply(mat, segs, tables=tables), iters=20)
        del segs, got, want

    # phases 18 and 19 on host stripes
    xs = [rand((8, STRIPE), 500 + i).cpu().numpy() for i in range(OBJECTS)]
    want = gk.apply_matrix_plain(coding, torch.from_numpy(np.concatenate(xs, axis=1)).to(dev)
                                 ).cpu().numpy()

    def same(outs, what: str) -> None:
        for i, got in enumerate(outs):
            assert np.array_equal(got, want[:, i * STRIPE:(i + 1) * STRIPE]), \
                f"{what}: parity of stripe {i} differs"

    wb = WriteBatcher(CephContext("osd.0"), entity="osd.0")
    wb.start()
    out = [None] * OBJECTS
    try:
        lat, wall = smoke.run_clients(
            OBJECTS, lambda i: out.__setitem__(i, wb.encode_chunks(coding, xs[i], key)))
    finally:
        wb.stop()
    same(out, "phase 18")
    assert wb.stats()["inline"] == 0
    res["p18_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    res["p18_p99_ms"] = float(np.percentile(lat, 99)) * 1e3
    res["p18_wall_ms"] = wall * 1e3

    wb = WriteBatcher(CephContext("osd.0", overrides={
        "ec_batch_window_ms": 10_000.0, "ec_batch_max_stripes": 10_000,
        "ec_batch_max_bytes": 1 << 30}), entity="osd.0")
    wb.start()
    try:
        tickets = [wb.encode_submit(coding, x, key) for x in xs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wb.flush_now()
        out = [wb.encode_wait(t) for t in tickets]
        res["p19_flush_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        wb.stop()
    same(out, "phase 19")
    assert (wb.stats()["flushes"], wb.stats()["device_batches"]) == (1, 1)
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
    (out / "k1_ab.json").write_text(json.dumps({"card": smi, "turns": turns}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
