"""osdmaptool analog — offline OSDMap inspection, PG mapping, upmap calc.

Reference: src/tools/osdmaptool.cc — `--createsimple`, `--test-map-pgs`
(batch-maps every PG of every pool and prints the per-OSD distribution) and
`--upmap` (runs OSDMap::calc_pg_upmaps and writes the `ceph osd
pg-upmap-items` commands an operator would apply).  Both batch modes run on
the card (OSDMap.map_pool → crush_do_rule_batch, whose straw2 draws are
K3), making this tool the CLI face of BASELINE config 5's pool-wide remap
measurement.  ``--device cpu`` maps on the host instead.

    python -m ceph_tpu_torch.tools.osdmaptool MAP.json --test-map-pgs

Map files are JSON (OSDMap.to_json) — the analog of the reference's binary
osdmap blobs.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..crush import CrushWrapper, build_hierarchical_map
from ..osd import OSDMap, calc_pg_upmaps
from ..osd.osdmap import PG_POOL_ERASURE


def _load(path: str, device=None) -> OSDMap:
    with open(path) as f:
        return OSDMap.from_json(json.load(f), device=device)


def _save(m: OSDMap, path: str) -> None:
    with open(path, "w") as f:
        json.dump(m.to_json(), f, indent=1)


def create_simple(num_osd: int, pg_num: int = 128) -> OSDMap:
    """--createsimple analog: one host per OSD (flat failure domains), a
    size-3 replicated pool and a 4+2 EC pool."""
    m = OSDMap(CrushWrapper(build_hierarchical_map(num_osd, 1)))
    m.create_pool(1, pg_num=pg_num, size=3, crush_rule=0, name="rbd")
    m.create_pool(
        2, pg_num=pg_num // 2, size=6, crush_rule=1,
        type=PG_POOL_ERASURE, name="ecpool",
    )
    return m


def test_map_pgs(m: OSDMap, pool_ids, out=sys.stdout) -> None:
    """--test-map-pgs analog; per-pool then per-OSD count table plus the
    min/max/avg summary the reference prints.  Counts, targets, and the
    deviation/skew columns come from the shared scoring core
    (osd/placement.py — the same numbers `ceph osd df` and the mgr
    placement module render, so the three surfaces can't drift)."""
    from ..osd.placement import cluster_report

    rep = cluster_report(m, pools=pool_ids)
    for pid in pool_ids:
        print(f"pool {pid} pg_num {m.pools[pid].pg_num}", file=out)
    counts = rep["osd_counts"]
    primaries = rep["osd_primaries"]
    targets = rep["osd_targets"]
    print("#osd\tcount\tprimary\ttarget\tdeviation", file=out)
    for o in range(m.max_osd):
        print(f"osd.{o}\t{counts[o]}\t{primaries[o]}"
              f"\t{targets[o]:.2f}\t{counts[o] - targets[o]:+.2f}",
              file=out)
    up_osds = [o for o in range(m.max_osd) if m.is_up(o)]
    act = counts[up_osds]
    avg = act.mean() if len(act) else 0.0
    print(f" in {len(up_osds)}", file=out)
    print(
        f" avg {avg:.2f} stddev {rep['stddev']:.2f} "
        f"min osd.{up_osds[int(act.argmin())]} {act.min()} "
        f"max osd.{up_osds[int(act.argmax())]} {act.max()}",
        file=out,
    )
    print(f" max deviation {rep['max_deviation']:.2f} "
          f"score {rep['score']:.4f}", file=out)
    size_sum = sum(m.pools[p].pg_num * m.pools[p].size for p in pool_ids)
    print(f" size {size_sum}", file=out)


def do_upmap(
    m: OSDMap, pool_ids, max_dev: float, max_iter: int, out=sys.stdout
) -> int:
    """--upmap analog: emit `ceph osd pg-upmap-items` commands, with the
    scoring core's before/after skew as trailing comment lines (the
    `balancer eval` pair, offline)."""
    from ..osd.placement import cluster_report

    # one batched sweep feeds both the pre score and the greedy loop
    # (the balancer module's two-sweeps-per-pass rule)
    mappings = {pid: m.map_pool(pid) for pid in pool_ids}
    pre = cluster_report(m, pools=pool_ids, mappings=mappings)
    changes = calc_pg_upmaps(
        m, max_deviation=max_dev, max_iterations=max_iter, pools=pool_ids,
        mappings=mappings,
    )
    by_pg: dict[tuple[int, int], list[int]] = {}
    for pid, ps, frm, to in changes:
        by_pg.setdefault((pid, ps), []).extend((frm, to))
    for (pid, ps), pairs in sorted(by_pg.items()):
        # pg ids print as <pool>.<ps hex>, as the reference does
        print(
            f"ceph osd pg-upmap-items {pid}.{ps:x} "
            + " ".join(str(p) for p in pairs),
            file=out,
        )
    post = cluster_report(m, pools=pool_ids) if changes else pre
    print(f"# score {pre['score']:.4f} -> {post['score']:.4f} "
          f"(max deviation {pre['max_deviation']:.2f} -> "
          f"{post['max_deviation']:.2f} PG shards)", file=out)
    return len(changes)


def main(argv=None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(
        prog="osdmaptool", description=__doc__.splitlines()[0]
    )
    ap.add_argument("mapfn", help="OSDMap JSON file")
    ap.add_argument(
        "--createsimple", type=int, metavar="NUM_OSD",
        help="create a simple map with NUM_OSD osds and write it to mapfn",
    )
    ap.add_argument("--pg-num", type=int, default=128)
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--pool", type=int, action="append", default=None)
    ap.add_argument(
        "--upmap", metavar="OUTFILE",
        help="calc upmap moves, write pg-upmap-items commands to OUTFILE "
        "('-' for stdout), and save the balanced map back to mapfn",
    )
    ap.add_argument("--upmap-deviation", type=float, default=1.0)
    ap.add_argument("--upmap-max", type=int, default=100)
    ap.add_argument("--dump", action="store_true", help="print map summary")
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="torch device the PG mappings run on (default cuda; cpu runs "
        "the straw2 draw's plain PyTorch version)",
    )
    args = ap.parse_args(argv)

    if args.createsimple:
        m = create_simple(args.createsimple, args.pg_num)
        _save(m, args.mapfn)
        print(
            f"osdmaptool: writing epoch {m.epoch} to {args.mapfn}", file=out
        )
        return 0

    try:
        m = _load(args.mapfn, args.device)
    except OSError as e:
        print(f"osdmaptool: couldn't open map file: {e}", file=sys.stderr)
        return 1
    except (ValueError, KeyError) as e:
        print(f"osdmaptool: {args.mapfn} is not an OSDMap JSON file: {e}",
              file=sys.stderr)
        return 1
    pools = args.pool if args.pool else sorted(m.pools)
    for pid in pools:
        if pid not in m.pools:
            print(f"osdmaptool: there is no pool {pid}", file=sys.stderr)
            return 1
    if args.dump:
        print(f"epoch {m.epoch}", file=out)
        print(f"max_osd {m.max_osd}", file=out)
        for pid in sorted(m.pools):
            p = m.pools[pid]
            kind = "erasure" if p.type == PG_POOL_ERASURE else "replicated"
            print(
                f"pool {pid} '{p.name}' {kind} size {p.size} pg_num "
                f"{p.pg_num} crush_rule {p.crush_rule}",
                file=out,
            )
    if args.test_map_pgs:
        test_map_pgs(m, pools, out=out)
    if args.upmap:
        sink = out if args.upmap == "-" else open(args.upmap, "w")
        try:
            n = do_upmap(
                m, pools, args.upmap_deviation, args.upmap_max, out=sink
            )
        finally:
            if sink is not out:
                sink.close()
        print(f"osdmaptool: {n} upmap changes", file=out)
        _save(m, args.mapfn)
    if not (args.test_map_pgs or args.upmap or args.dump):
        print(f"osdmaptool: osdmap file {args.mapfn!r}: epoch {m.epoch}", file=out)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `osdmaptool ... | head`
        sys.exit(141)
