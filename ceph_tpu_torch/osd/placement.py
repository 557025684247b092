"""cephplace — the placement scoring core on batched CRUSH.

Reference: the distribution math behind `ceph osd df` (PGMap's per-OSD
PG counts vs weight share), osdmaptool `--test-map-pgs`, and the mgr
balancer's `eval` score (src/pybind/mgr/balancer/module.py ::
Eval/calc_stats) — collapsed into ONE pure implementation shared by
every consumer (the mgr placement module, the balancer, `ceph osd df`,
and osdmaptool), so the three surfaces can never disagree about what
"skewed" means.

Everything here is pure map arithmetic over batched mappings: the CRUSH
descent itself runs as `OSDMap.map_pool` → `crush_do_rule_batch` (ONE
device launch per pool, visible in kernel telemetry), and this module
only does vectorized host post-passes on the resulting [pg_num, size]
arrays — the same split SURVEY.md §3.3 prescribes for batch consumers.

Three product families:

- **counts**: per-OSD PG-shard and primary counts from a mapping
  (`shard_counts`, `pool_pg_counts`);
- **skew**: weight-proportional ideal shares and deviation metrics
  (`ideal_targets`, `skew_metrics`, `pool_skew`, `cluster_report`) —
  ``max_deviation``/``stddev`` are in PG shards, ``score`` is the
  stddev normalized by the mean ideal share (0 = perfectly balanced,
  dimensionless so pools of different sizes compare);
- **diff**: epoch-over-epoch remap forecasting (`diff_mappings`) — PGs
  and shards whose placement changed between two device-batched
  mappings, with predicted bytes-to-move when per-shard byte weights
  are supplied (the mgr derives them from pool stats).
"""
from __future__ import annotations

import numpy as np

from ..crush.types import RuleOp
from .osdmap import OSDMap, PG_POOL_ERASURE


def _rule_take_and_type(osdmap: OSDMap, rule_id: int) -> tuple[int, int]:
    """Extract (take root, failure-domain type) from a simple rule chain."""
    root, ftype = None, 0
    for st in osdmap.crush.map.rules[rule_id].steps:
        if st.op == RuleOp.TAKE:
            root = st.arg1
        elif st.op in (
            RuleOp.CHOOSE_FIRSTN,
            RuleOp.CHOOSE_INDEP,
            RuleOp.CHOOSELEAF_FIRSTN,
            RuleOp.CHOOSELEAF_INDEP,
        ):
            ftype = st.arg2
    if root is None:
        raise ValueError(f"rule {rule_id} has no TAKE step")
    return root, ftype


def rule_osd_info(
    osdmap: OSDMap, rule_id: int
) -> tuple[np.ndarray, dict[int, int]]:
    """Per-OSD CRUSH weight and failure-domain id for one rule's subtree.

    reference: OSDMap::get_rule_weight_osd_map (weights) plus the subtree
    walk calc_pg_upmaps does to group candidates by failure domain."""
    root, ftype = _rule_take_and_type(osdmap, rule_id)
    weights = np.zeros(osdmap.max_osd, dtype=np.float64)
    for osd, w in osdmap.crush.get_rule_weight_osd_map(rule_id).items():
        if osd < osdmap.max_osd:
            weights[osd] = w
    domain: dict[int, int] = {}

    def walk(bid: int, dom: int | None) -> None:
        b = osdmap.crush.map.buckets[bid]
        here = bid if b.type == ftype else dom
        for it in b.items:
            if it >= 0:
                domain[it] = it if ftype == 0 else (here if here is not None else it)
            else:
                walk(it, here)

    walk(root, None)
    # an out (reweight 0) OSD takes no PGs — exclude from the target share
    for o in range(osdmap.max_osd):
        if osdmap.osd_weight[o] == 0 or not osdmap.is_up(o):
            weights[o] = 0.0
    return weights, domain


def shard_counts(mapping, max_osd: int) -> np.ndarray:
    """Per-OSD shard count over one mapping array (up [pg_num, size] or
    primaries [pg_num]); ITEM_NONE holes don't count."""
    counts = np.zeros(max_osd, dtype=np.int64)
    arr = np.asarray(mapping)
    valid = arr[(arr >= 0) & (arr < max_osd)]
    if valid.size:
        ids, c = np.unique(valid, return_counts=True)
        counts[ids] += c
    return counts


def pool_pg_counts(osdmap: OSDMap, pools=None) -> np.ndarray:
    """PG-shard count per OSD over the given pools (batched CRUSH path)."""
    counts = np.zeros(osdmap.max_osd, dtype=np.int64)
    for pid in pools if pools is not None else sorted(osdmap.pools):
        up, _ = osdmap.map_pool(pid)
        counts += shard_counts(up, osdmap.max_osd)
    return counts


def ideal_targets(weights: np.ndarray, total_shards: int) -> np.ndarray:
    """Weight-proportional ideal shard share per OSD (reference: the
    `target` term of calc_pg_upmaps / balancer eval).  Zero-weight
    (out/down) OSDs get target 0."""
    total_w = float(np.asarray(weights).sum())
    if total_w <= 0:
        return np.zeros(len(weights), dtype=np.float64)
    return np.asarray(weights, dtype=np.float64) / total_w * float(total_shards)


def skew_metrics(counts: np.ndarray, target: np.ndarray,
                 eligible: np.ndarray) -> dict:
    """Deviation metrics over the eligible (weight > 0) OSDs:
    ``max_deviation``/``stddev`` in PG shards, ``score`` = stddev
    normalized by the mean ideal share (0 = perfect)."""
    eligible = np.asarray(eligible, dtype=bool)
    if not eligible.any():
        return {"max_deviation": 0.0, "stddev": 0.0, "score": 0.0}
    d = np.asarray(counts, dtype=np.float64)[eligible] \
        - np.asarray(target, dtype=np.float64)[eligible]
    mean_t = float(np.asarray(target, dtype=np.float64)[eligible].mean())
    stddev = float(np.sqrt((d * d).mean()))
    return {
        "max_deviation": float(np.abs(d).max()),
        "stddev": stddev,
        "score": stddev / max(1.0, mean_t),
    }


def pool_skew(osdmap: OSDMap, pool_id: int, up=None) -> dict:
    """One pool's distribution report: per-OSD counts vs the
    weight-proportional ideal plus the skew metrics.  `up` accepts a
    precomputed `map_pool` result so one batched scan feeds every
    consumer (the mgr module computes mappings once per epoch)."""
    pool = osdmap.pools[pool_id]
    if up is None:
        up, _ = osdmap.map_pool(pool_id)
    weights, _dom = rule_osd_info(osdmap, pool.crush_rule)
    counts = shard_counts(up, osdmap.max_osd)
    placed = int((np.asarray(up) >= 0).sum())
    target = ideal_targets(weights, placed)
    eligible = weights > 0
    return {
        "pool": pool_id,
        "name": pool.name,
        "pg_num": pool.pg_num,
        "size": pool.size,
        "shards": placed,
        "counts": counts,
        "target": target,
        "eligible": eligible,
        **skew_metrics(counts, target, eligible),
    }


def cluster_report(osdmap: OSDMap, pools=None, mappings=None) -> dict:
    """Full-cluster distribution report: per-pool skew + aggregated
    per-OSD counts/targets/primaries + cluster-level metrics.

    `mappings` is an optional {pool_id: (up, primaries)} of precomputed
    `map_pool` results; absent pools are mapped here (each one batched
    CRUSH launch)."""
    pids = list(pools) if pools is not None else sorted(osdmap.pools)
    per_pool: dict[int, dict] = {}
    counts = np.zeros(osdmap.max_osd, dtype=np.int64)
    primaries = np.zeros(osdmap.max_osd, dtype=np.int64)
    targets = np.zeros(osdmap.max_osd, dtype=np.float64)
    eligible = np.zeros(osdmap.max_osd, dtype=bool)
    for pid in pids:
        if mappings is not None and pid in mappings:
            up, prim = mappings[pid]
        else:
            up, prim = osdmap.map_pool(pid)
        sk = pool_skew(osdmap, pid, up=up)
        per_pool[pid] = sk
        counts += sk["counts"]
        targets += sk["target"]
        eligible |= sk["eligible"]
        primaries += shard_counts(prim, osdmap.max_osd)
    return {
        "epoch": osdmap.epoch,
        "pools": per_pool,
        "osd_counts": counts,
        "osd_primaries": primaries,
        "osd_targets": targets,
        "eligible": eligible,
        **skew_metrics(counts, targets, eligible),
    }


def diff_mappings(osdmap: OSDMap, prev: dict, cur: dict,
                  shard_bytes: dict | None = None) -> dict:
    """Epoch-over-epoch remap forecast from two batched mappings.

    `prev`/`cur` are {pool_id: up [pg_num, size]} from the old and new
    maps.  A shard is REMAPPED when its current slot holds an OSD the
    PG's previous placement did not (positional for EC — shard identity
    is positional; set-membership for replicated — the up list compacts
    and reorders freely).  Shards landing in a -1 hole are degraded,
    not misplaced, and don't count.  `shard_bytes` maps pool_id to the
    average bytes one shard carries (the mgr derives it from reported
    pool stats) for the predicted-bytes-to-move forecast."""
    shard_bytes = shard_bytes or {}
    per_pool: dict[int, dict] = {}
    tot_pgs = tot_shards = 0
    total_shards_cur = 0
    predicted = 0.0
    for pid in sorted(set(cur)):
        b = np.asarray(cur[pid])
        total_shards_cur += int((b >= 0).sum())
    for pid in sorted(set(prev) & set(cur)):
        pool = osdmap.pools.get(pid)
        a = np.asarray(prev[pid])
        b = np.asarray(cur[pid])
        if pool is None:
            continue
        if a.shape != b.shape:
            # pg_num/size changed (split): every currently-placed shard
            # is potentially moving — count them all, flagged
            moved_per_pg = (b >= 0).sum(axis=1)
            resized = True
        elif pool.type == PG_POOL_ERASURE:
            moved_per_pg = ((a != b) & (b >= 0)).sum(axis=1)
            resized = False
        else:
            # replicated: membership, not position (the up list compacts)
            member = (b[:, :, None] == a[:, None, :]).any(axis=2)
            moved_per_pg = (~member & (b >= 0)).sum(axis=1)
            resized = False
        pgs_moved = int((moved_per_pg > 0).sum())
        shards_moved = int(moved_per_pg.sum())
        if not pgs_moved:
            continue
        pool_bytes = float(shard_bytes.get(pid, 0.0)) * shards_moved
        per_pool[pid] = {
            "name": pool.name,
            "pg_num": int(b.shape[0]),
            "pgs_remapped": pgs_moved,
            "shards_remapped": shards_moved,
            "predicted_bytes": int(pool_bytes),
            "resized": resized,
        }
        tot_pgs += pgs_moved
        tot_shards += shards_moved
        predicted += pool_bytes
    return {
        "pools": per_pool,
        "pgs_remapped": tot_pgs,
        "shards_remapped": tot_shards,
        "total_shards": total_shards_cur,
        "misplaced_fraction": (tot_shards / total_shards_cur
                               if total_shards_cur else 0.0),
        "predicted_bytes": int(predicted),
        "pools_added": sorted(set(cur) - set(prev)),
        "pools_removed": sorted(set(prev) - set(cur)),
    }


def osd_rows(report: dict, osdmap: OSDMap) -> list[dict]:
    """Flatten a cluster_report into JSON-safe per-OSD rows — the shape
    `ceph osd df`'s deviation columns and the mgr's ceph_placement_*
    per-OSD series both consume (one implementation, every consumer)."""
    rows = []
    counts = report["osd_counts"]
    prims = report["osd_primaries"]
    targets = report["osd_targets"]
    eligible = report["eligible"]
    # bound by the report's arrays: a map whose max_osd grew since the
    # report was scanned must not index past them (new OSDs get rows
    # once a scan covers them)
    for o in range(min(osdmap.max_osd, len(counts))):
        if not osdmap.exists(o):
            continue
        rows.append({
            "osd": o,
            "shards": int(counts[o]),
            "primaries": int(prims[o]),
            "target": round(float(targets[o]), 2),
            "deviation": round(float(counts[o] - targets[o]), 2),
            "eligible": bool(eligible[o]),
        })
    return rows
