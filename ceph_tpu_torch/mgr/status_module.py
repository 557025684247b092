"""Status module — cluster summary assembly and the mon digest
(reference: the mgr side of `ceph -s`/`ceph osd status`
src/pybind/mgr/status/module.py, plus the MMonMgrReport digest the mgr
streams to the mon so MgrStatMonitor can answer `ceph df`/`pg dump`
from the monitor)."""
from __future__ import annotations

import weakref

from ..ops.nvcc import KernelError
from ..osd.osdmap import PG_POOL_ERASURE
from .module import MgrModule, register_module

#: assemble_osd_df's fallback scan, memoized per (map object, epoch) —
#: see the comment at its use site
_OSD_DF_MEMO: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pool_usage(m, stats: dict) -> dict[int, dict]:
    """{pool_id: {"bytes": logical, "objects": n, "raw_bytes": raw}} —
    raw sums across daemon reports, logical divides out the redundancy
    factor (replica count, or size/k for EC)."""
    usage: dict[int, dict] = {}
    if m is None:
        return usage
    for pid, pool in m.pools.items():
        raw = 0
        objs = 0
        for st in stats.values():
            raw += int(st.get("pool_bytes", {}).get(str(pid), 0))
            objs += int(st.get("pool_objects", {}).get(str(pid), 0))
        if pool.type == PG_POOL_ERASURE:
            prof = m.ec_profiles.get(pool.ec_profile or "", {})
            k = int(prof.get("k", 2))
            factor = pool.size / max(k, 1)
        else:
            factor = max(pool.size, 1)
        usage[pid] = {
            "bytes": int(raw / factor),
            # object counts are per-replica too: each copy/shard is
            # one store object
            "objects": objs // max(pool.size, 1),
            "raw_bytes": raw,
            "factor": factor,
        }
    return usage


def assemble_df(m, stats: dict) -> dict:
    """`ceph df` payload (reference: PGMap::dump_cluster_stats +
    dump_pool_stats_full)."""
    total = used = avail = 0
    for st in stats.values():
        sf = st.get("statfs") or {}
        total += int(sf.get("total", 0))
        used += int(sf.get("used", 0))
        avail += int(sf.get("avail", 0))
    usage = pool_usage(m, stats)
    pools = []
    if m is not None:
        for pid, pool in sorted(m.pools.items()):
            u = usage.get(pid, {})
            factor = u.get("factor", 1) or 1
            stored = u.get("bytes", 0)
            max_avail = int(avail / factor)
            denom = stored + max_avail
            pools.append({
                "id": pid,
                "name": pool.name,
                "stored": stored,
                "objects": u.get("objects", 0),
                "kb_used": -(-u.get("raw_bytes", 0) // 1024),
                "percent_used": stored / denom if denom else 0.0,
                "max_avail": max_avail,
                "quota_bytes": pool.quota_max_bytes,
                "quota_objects": pool.quota_max_objects,
            })
    return {
        "stats": {
            "total_bytes": total,
            "total_used_raw_bytes": used,
            "total_avail_bytes": avail,
        },
        "pools": pools,
    }


def assemble_osd_df(m, stats: dict, placement: list | None = None,
                    skew: dict | None = None) -> dict:
    """`ceph osd df` payload (reference: OSDMonitor print_utilization
    via PGMap::dump_osd_stats).

    cephplace: the deviation/skew columns come from the SHARED scoring
    core (osd/placement.py) — `placement` accepts the placement
    module's cached per-OSD rows and `skew` its cluster-level
    max_deviation/stddev (so the summary shares the core's unrounded
    metrics instead of re-deriving them from rounded rows); absent a
    module, the core computes both here from a fresh batched scan."""
    if placement is None and m is not None and m.pools:
        # memoized per MAP OBJECT (weak — no hidden state written onto
        # the domain object) and validated by epoch (mon-side mutators
        # bump epoch in place), so the fallback costs one batched scan
        # per epoch — not one per digest tick — when the placement
        # module isn't hosted to hand us its cached rows
        try:
            hit = _OSD_DF_MEMO.get(m)
            if hit is not None and hit[0] == m.epoch:
                placement, skew = hit[1], hit[2]
            else:
                from ..osd.placement import cluster_report, osd_rows

                report = cluster_report(m)
                placement = osd_rows(report, m)
                skew = {"max_deviation": report["max_deviation"],
                        "stddev": report["stddev"]}
                _OSD_DF_MEMO[m] = (m.epoch, placement, skew)
        except KernelError:
            raise
        except Exception:
            placement = skew = None  # torn map mid-change: skip
    by_osd = {r["osd"]: r for r in (placement or [])}
    rows = []
    if m is not None:
        for o in range(m.max_osd):
            if not m.exists(o):
                continue
            st = stats.get(f"osd.{o}", {})
            sf = st.get("statfs") or {}
            total = int(sf.get("total", 0))
            used = int(sf.get("used", 0))
            pl = by_osd.get(o) or {}
            rows.append({
                "id": o,
                "up": int(m.is_up(o)),
                "in": int(m.is_in(o)),
                "reweight": m.osd_weight[o] / 0x10000,
                "size": total,
                "use": used,
                "avail": int(sf.get("avail", 0)),
                "utilization": used / total if total else 0.0,
                "pgs": st.get("num_pgs", 0),
                # scoring-core columns (shards mapped by the batched
                # scan vs the weight-proportional ideal)
                "pgs_mapped": pl.get("shards", 0),
                "target": pl.get("target", 0.0),
                "deviation": pl.get("deviation", 0.0),
            })
    n = len(rows) or 1
    if skew is None:
        # last resort (rows handed in without the core's summary):
        # recompute over ELIGIBLE OSDs only, matching skew_metrics —
        # an out OSD's 0.0 row must not dilute stddev
        devs = [r["deviation"] for r in rows
                if (by_osd.get(r["id"]) or {}).get("eligible")]
        skew = {
            "max_deviation": max((abs(d) for d in devs), default=0.0),
            "stddev": ((sum(d * d for d in devs) / len(devs)) ** 0.5
                       if devs else 0.0),
        }
    return {
        "nodes": rows,
        "summary": {
            "total_kb": sum(r["size"] for r in rows) // 1024,
            "total_kb_used": sum(r["use"] for r in rows) // 1024,
            "average_utilization":
                sum(r["utilization"] for r in rows) / n,
            "max_deviation": float(skew.get("max_deviation") or 0.0),
            "stddev": float(skew.get("stddev") or 0.0),
        },
    }


def assemble_osd_rows(m, stats: dict) -> list[dict]:
    """Per-OSD status rows — shared by `ceph osd status` (this module)
    and the dashboard's /api/osd so they can never drift apart."""
    rows = []
    if m is not None:
        for o in range(m.max_osd):
            if not m.exists(o):
                continue
            st = stats.get(f"osd.{o}", {})
            rows.append({
                "id": o,
                "up": int(m.is_up(o)),
                "in": int(m.is_in(o)),
                "pgs": st.get("num_pgs", 0),
                "objects": st.get("num_objects", 0),
            })
    return rows


@register_module
class StatusModule(MgrModule):
    NAME = "status"

    def osd_status(self) -> dict:
        m = self.get("osd_map")
        return {
            "epoch": m.epoch if m else 0,
            "osds": assemble_osd_rows(m, self.mgr.latest_stats()),
        }

    def build_digest(self) -> dict:
        """The MMonMgrReport payload: everything the mon needs to
        answer `df`/`osd df`/`pg dump` without talking to OSDs."""
        m = self.get("osd_map")
        # ONE report snapshot feeds every section, so pg_info can never
        # name a daemon the slow-op/df views disagree about
        stats_ts = self.mgr.latest_stats_with_ts()
        stats = {d: s for d, (_t, s) in stats_ts.items()}
        # pg_info rows merged OLDEST-report-first so on a pgid collision
        # (primary change: the dead primary's last report lingers) the
        # FRESHEST author wins (cephheal)
        pg_info: dict[str, dict] = {}
        for _ts, st in sorted(stats_ts.values(), key=lambda tv: tv[0]):
            pg_info.update(st.get("pg_info") or {})
        slow = {d: int(st.get("slow_ops", 0))
                for d, st in stats.items() if st.get("slow_ops")}
        # per-daemon detail lines (cephmeter: each names its op's
        # dominant stage) ride along only for daemons with slow ops
        slow_detail = {d: st.get("slow_ops_detail")
                       for d, st in stats.items()
                       if st.get("slow_ops") and st.get("slow_ops_detail")}
        # accelerator health (common/kernel_telemetry.py): forward only
        # daemons with something to report — a degraded sentinel or an
        # active kernel-fallback latch — so the digest stays small and
        # the mon's checks key directly off presence
        backend: dict[str, dict] = {}
        for d, st in stats.items():
            bh = st.get("backend_health") or {}
            sent = bh.get("sentinel") or {}
            if sent.get("state") == "degraded" or bh.get("fallback"):
                backend[d] = bh
        # cephheal: the progress module's event/stalled snapshot rides
        # the digest so the mon can answer `progress`, render the
        # `ceph status` recovery line, and raise RECOVERY_STALLED —
        # tolerant of the module not being hosted
        progress = None
        prog_mod = self.mgr._modules.get("progress")
        if prog_mod is not None:
            try:
                progress = prog_mod.snapshot()
            except Exception as e:
                self.cct.dout("mgr", 3,
                              f"progress snapshot failed: {e!r}")
        # cephplace: the placement module's skew/diff snapshot and the
        # balancer's pass stats ride the digest so the mon answers
        # `placement diff`/`balancer status` and raises PG_IMBALANCE —
        # tolerant of either module not being hosted
        placement = None
        placement_rows = placement_skew = None
        pl_mod = self.mgr._modules.get("placement")
        if pl_mod is not None:
            try:
                placement = pl_mod.snapshot()
                # rows + skew come from ONE locked report snapshot so a
                # scan landing mid-digest can't mismatch them
                placement_rows, placement_skew = pl_mod.df_inputs()
            except Exception as e:
                self.cct.dout("mgr", 3,
                              f"placement snapshot failed: {e!r}")
        balancer = None
        bal_mod = self.mgr._modules.get("balancer")
        if bal_mod is not None:
            try:
                balancer = bal_mod.status()
            except Exception as e:
                self.cct.dout("mgr", 3,
                              f"balancer snapshot failed: {e!r}")
        return {
            "df": assemble_df(m, stats),
            "osd_df": assemble_osd_df(m, stats, placement=placement_rows,
                                      skew=placement_skew),
            "placement": placement,
            "balancer": balancer,
            "pg_info": pg_info,
            "slow_ops": slow,
            "slow_ops_detail": slow_detail,
            "backend_health": backend,
            "progress": progress,
            # compact metrics-history snapshot: the mon's `perf history`
            # command answers from this (cephmeter; the mon has no
            # channel TO the mgr, so the history rides the digest)
            "perf_history": self.mgr.metrics_history.digest(),
        }

    def serve(self) -> None:
        interval = float(self.cct.conf.get("mgr_digest_interval"))
        while not self._stop.wait(timeout=interval):
            try:
                rv, res = self.mon_command({
                    "prefix": "mgr digest",
                    "digest": self.build_digest(),
                })
                if rv != 0:
                    self.cct.dout("mgr", 3,
                                  f"digest push refused: {rv} {res}")
            except KernelError:
                raise
            except Exception as e:
                self.cct.dout("mgr", 3, f"digest push failed: {e!r}")
