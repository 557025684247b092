"""Upmap balancer — the calc_pg_upmaps optimization loop on batched CRUSH.

Reference: src/osd/OSDMap.cc :: OSDMap::calc_pg_upmaps, driven by the mgr
balancer module (src/pybind/mgr/balancer/module.py, upmap mode): clone the
map, find over/underfull OSDs vs their weight-proportional PG share, and
emit pg_upmap_items entries moving PG shards from the fullest OSD to the
emptiest one that keeps the placement valid (same eligible device set,
distinct failure domains).  This is SURVEY.md §3.3's flagship batch-CRUSH
consumer: the full pool map runs as ONE crush_do_rule_batch call on the card (K3),
and the greedy loop then only does sparse host-side bookkeeping — upmap
overrides never change the raw CRUSH output, so counts update incrementally
without re-descending.

The weight/target/count arithmetic lives in the shared scoring core
(osd/placement.py — cephplace), so the balancer, `ceph osd df`, the mgr
placement module, and osdmaptool all agree on what a deviation is.

The reference's loop additionally retries candidate deviations in a few
stochastic orders; this implementation is deterministic greedy (largest
deviation first), which the tests exploit for stable golden behavior.
"""
from __future__ import annotations

import numpy as np

from .osdmap import OSDMap
from .placement import (  # noqa: F401  (re-exported: historical import site)
    ideal_targets,
    pool_pg_counts,
    rule_osd_info,
    shard_counts,
)


def calc_pg_upmaps(
    osdmap: OSDMap,
    max_deviation: float = 1.0,
    max_iterations: int = 100,
    pools=None,
    mappings: dict | None = None,
) -> list[tuple[int, int, int, int]]:
    """Greedy upmap balance; mutates osdmap.pg_upmap_items.

    Returns the applied changes as (pool, ps, from_osd, to_osd) tuples —
    the analog of the incremental OSDMap::calc_pg_upmaps fills for the mgr
    balancer to commit.  max_deviation is in PG shards, as in the reference
    (osd_calc_pg_upmaps_max_deviation, default 1 → perfectly tight).
    `mappings` accepts precomputed {pool_id: (up, primaries)} map_pool
    results for the UNMUTATED map, so one batched sweep can feed both
    the caller's pre-pass score and this loop (the greedy bookkeeping is
    host-incremental — it never re-descends after its own changes, so a
    pre-change mapping is exactly what it starts from anyway)."""
    changes: list[tuple[int, int, int, int]] = []
    for pid in pools if pools is not None else sorted(osdmap.pools):
        pool = osdmap.pools[pid]
        weights, domain = rule_osd_info(osdmap, pool.crush_rule)
        if weights.sum() <= 0:
            continue
        if mappings is not None and pid in mappings:
            up = mappings[pid][0]
        else:
            up, _ = osdmap.map_pool(pid)
        rows = [list(r) for r in up]
        counts = shard_counts(up, osdmap.max_osd).astype(np.float64)
        shards = sum(1 for r in rows for o in r if o >= 0)
        target = ideal_targets(weights, shards)
        eligible = weights > 0

        for _ in range(max_iterations):
            dev = np.where(eligible, counts - target, -np.inf)
            o_hi = int(np.argmax(dev))
            if dev[o_hi] <= max_deviation:
                break
            # underfull candidates, emptiest first
            under = np.where(eligible, counts - target, np.inf)
            candidates = [int(o) for o in np.argsort(under) if under[o] < 0]
            moved = False
            for ps, row in enumerate(rows):
                if o_hi not in row or moved:
                    continue
                others = {domain.get(o) for o in row if o >= 0 and o != o_hi}
                for o_lo in candidates:
                    if o_lo in row or domain.get(o_lo) in others:
                        continue
                    if under[o_lo] >= dev[o_hi] - 1:
                        break  # no move can improve the spread
                    key = (pid, ps)
                    osdmap.pg_upmap_items.setdefault(key, []).append(
                        (o_hi, o_lo)
                    )
                    row[row.index(o_hi)] = o_lo
                    counts[o_hi] -= 1
                    counts[o_lo] += 1
                    changes.append((pid, ps, o_hi, o_lo))
                    moved = True
                    break
            if not moved:
                break
    if changes:  # one logical map revision per calc, as OSDMonitor commits
        osdmap.epoch += 1
    return changes
