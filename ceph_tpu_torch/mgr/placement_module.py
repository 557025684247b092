"""placement — cephplace: placement-plane observability on batched CRUSH
(reference: the distribution half of PGMap/`ceph osd df` deviation plus
the OBJECT_MISPLACED accounting `ceph status` renders during a remap —
recast as a mgr module because in this tree the mgr is where batched
mappings and daemon stats already meet).

One loop, three products per scan (the scan runs on every osdmap-epoch
change, plus a periodic tick every ``mgr_placement_interval``):

1. **Distribution analytics** — the full cluster PG→OSD mapping as one
   ``OSDMap.map_pool`` → ``crush_do_rule_batch`` launch per pool (the
   batched device path, visible in kernel telemetry), folded by the
   shared scoring core (``osd/placement.py``) into per-OSD shard/primary
   counts vs the weight-proportional ideal and per-pool skew scores
   (max deviation, stddev, normalized score) — exported as
   ``ceph_placement_*{pool,osd}`` labeled series via the mgr's own
   report sink (prometheus + metrics_history).

2. **Remap forecasting** — on epoch advance, the previous epoch's
   mappings (already device-batched, cached from the last scan) diff
   against the new ones into PGs/shards remapped and predicted
   bytes-to-move (per-shard byte weights from reported pool stats) —
   the misplaced-fraction forecast a 1M-PG storm simulation asserts
   against.  Exported as ``ceph_remap_*`` series and served as the
   ``placement diff`` mon command (the snapshot rides the status
   module's digest, like progress).

3. **Imbalance health** — pools whose max deviation exceeds
   ``mgr_placement_max_deviation`` while the balancer is idle or off
   feed the mon's ``PG_IMBALANCE`` check; a busy balancer (active and
   recently committing moves) suppresses it so an in-flight convergence
   doesn't flap the health state.
"""
from __future__ import annotations

import time

from ..common.lockdep import make_lock
from ..common.tracer import TRACER
from ..ops.nvcc import KernelError
from ..osd.placement import cluster_report, diff_mappings, osd_rows
from .module import MgrModule, register_module


@register_module
class PlacementModule(MgrModule):
    NAME = "placement"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._lock = make_lock("mgr::placement")
        # serializes whole scans: the serve loop and direct scan()
        # callers (tests, the smoke) race on epoch changes, and two
        # concurrent scans of one transition would both book the diff —
        # doubling the cumulative ceph_remap_* counters the storm
        # simulation asserts against (always taken OUTSIDE self._lock)
        self._scan_lock = make_lock("mgr::placement::scan")
        self._last_epoch: int | None = None
        self._mappings: dict | None = None   # pid -> (up, primaries)
        self._report: dict | None = None     # last cluster_report
        self._map = None                     # the map _report was scanned on
        self._last_diff: dict | None = None  # last epoch diff (JSON-safe)
        self._diff_ts: float | None = None
        self._last_scan_ts: float = 0.0
        self._stats = {
            "scans": 0, "epochs_diffed": 0,
            "pgs_remapped_total": 0, "shards_remapped_total": 0,
            "predicted_bytes_total": 0,
        }

    # -- inputs --------------------------------------------------------------
    def _shard_bytes(self, m) -> dict[int, float]:
        """{pool_id: avg raw bytes per PG shard} from the daemons' pool
        stats — the byte weight one remapped shard is predicted to move."""
        stats = self.mgr.latest_stats()
        out: dict[int, float] = {}
        for pid, pool in m.pools.items():
            raw = sum(int((st.get("pool_bytes") or {}).get(str(pid), 0))
                      for st in stats.values())
            out[pid] = raw / max(1, pool.pg_num * pool.size)
        return out

    # -- one scan ------------------------------------------------------------
    def scan(self) -> dict | None:
        """Map every pool (batched), score the distribution, and — when
        the epoch advanced since the cached scan — forecast the remap.
        Returns the cluster report (None when no map/pools yet)."""
        with self._scan_lock:
            return self._scan_locked()

    def _scan_locked(self) -> dict | None:
        m = self.get("osd_map")
        if m is None or not m.pools:
            return None
        mappings = {pid: m.map_pool(pid) for pid in sorted(m.pools)}
        report = cluster_report(m, mappings=mappings)
        with self._lock:
            prev_epoch = self._last_epoch
            prev_maps = self._mappings
        diff = None
        if prev_maps is not None and m.epoch != prev_epoch:
            diff = diff_mappings(
                m,
                {pid: up for pid, (up, _p) in prev_maps.items()},
                {pid: up for pid, (up, _p) in mappings.items()},
                shard_bytes=self._shard_bytes(m),
            )
            diff["from_epoch"] = prev_epoch
            diff["to_epoch"] = m.epoch
        now = time.monotonic()
        with self._lock:
            self._last_epoch = m.epoch
            self._mappings = mappings
            self._report = report
            self._map = m
            self._last_scan_ts = now
            self._stats["scans"] += 1
            if diff is not None:
                self._last_diff = diff
                self._diff_ts = now
                self._stats["epochs_diffed"] += 1
                self._stats["pgs_remapped_total"] += diff["pgs_remapped"]
                self._stats["shards_remapped_total"] += \
                    diff["shards_remapped"]
                self._stats["predicted_bytes_total"] += \
                    diff["predicted_bytes"]
        if diff is not None and (diff["pgs_remapped"] or diff["pools_added"]
                                 or diff["pools_removed"]):
            TRACER.tracepoint(
                "placement", "epoch_diff", entity="mgr",
                from_epoch=diff["from_epoch"], to_epoch=diff["to_epoch"],
                pgs_remapped=diff["pgs_remapped"],
                shards_remapped=diff["shards_remapped"],
                misplaced_fraction=round(diff["misplaced_fraction"], 4),
                predicted_bytes=diff["predicted_bytes"])
        self.export()
        return report

    def tick(self) -> None:
        """Scan when the map moved or the periodic interval elapsed (the
        serve loop polls faster than the interval so an epoch change is
        picked up promptly)."""
        m = self.get("osd_map")
        if m is None:
            return
        interval = float(self.cct.conf.get("mgr_placement_interval"))
        with self._lock:
            due = (self._last_epoch != m.epoch
                   or time.monotonic() - self._last_scan_ts >= interval)
        if due:
            self.scan()

    # -- health + digest -----------------------------------------------------
    def imbalanced(self) -> list[dict]:
        """Pools whose max deviation exceeds the declared bound — the
        PG_IMBALANCE inputs (JSON-safe)."""
        thr = float(self.cct.conf.get("mgr_placement_max_deviation"))
        with self._lock:
            report = self._report
        if report is None:
            return []
        return [
            {"pool": sk["name"], "pool_id": pid,
             "max_deviation": round(sk["max_deviation"], 2),
             "stddev": round(sk["stddev"], 2),
             "score": round(sk["score"], 4)}
            for pid, sk in sorted(report["pools"].items())
            if sk["max_deviation"] > thr
        ]

    def _balancer_busy(self) -> bool:
        """True while the balancer is active AND recently committing
        moves — an in-flight convergence must not raise PG_IMBALANCE."""
        if not bool(self.cct.conf.get("mgr_balancer_active")):
            return False
        bal = self.mgr._modules.get("balancer")
        if bal is None:
            return False
        try:
            lp = bal.last_pass()
        except Exception:
            return False
        if not lp or not lp.get("committed"):
            return False
        grace = 2.0 * float(self.cct.conf.get("mgr_balancer_interval"))
        return time.monotonic() - lp.get("ts", 0.0) <= grace

    def df_inputs(self) -> tuple[list | None, dict | None]:
        """(per-OSD rows, cluster skew) for `ceph osd df` — BOTH from
        one report snapshot taken under the lock, so the digest can
        never pair one epoch's rows with another's summary.  Rows pair
        the report with the MAP IT WAS SCANNED ON — a newer map (e.g.
        max_osd grew) must wait for its own scan."""
        with self._lock:
            report, m = self._report, self._map
        if report is None or m is None:
            return None, None
        return osd_rows(report, m), {
            "max_deviation": report["max_deviation"],
            "stddev": report["stddev"],
        }

    def snapshot(self) -> dict:
        """The digest section: per-pool skew, imbalance state, and the
        last epoch diff — everything the mon needs for PG_IMBALANCE and
        the `placement diff` command (JSON-safe by construction)."""
        now = time.monotonic()
        with self._lock:
            report = self._report
            diff = self._last_diff
            diff_ts = self._diff_ts
            stats = dict(self._stats)
        pools = []
        cluster = None
        if report is not None:
            cluster = {"epoch": report["epoch"],
                       "score": round(report["score"], 4),
                       "max_deviation": round(report["max_deviation"], 2),
                       "stddev": round(report["stddev"], 2)}
            pools = [
                {"pool": sk["name"], "pool_id": pid,
                 "pg_num": sk["pg_num"], "shards": sk["shards"],
                 "max_deviation": round(sk["max_deviation"], 2),
                 "stddev": round(sk["stddev"], 2),
                 "score": round(sk["score"], 4)}
                for pid, sk in sorted(report["pools"].items())
            ]
        out = {
            "cluster": cluster,
            "pools": pools,
            "imbalanced": self.imbalanced(),
            "balancer_busy": self._balancer_busy(),
            "max_deviation_threshold": float(
                self.cct.conf.get("mgr_placement_max_deviation")),
            "stats": stats,
            "diff": None,
        }
        if diff is not None:
            out["diff"] = {
                **diff,
                "pools": {str(k): v for k, v in diff["pools"].items()},
                "misplaced_fraction": round(diff["misplaced_fraction"], 6),
                "age_seconds": round(now - (diff_ts or now), 1),
            }
        return out

    # -- export --------------------------------------------------------------
    def export(self) -> None:
        """ceph_placement_*{pool,osd} + ceph_remap_* series through the
        mgr's own report sink (prometheus + metrics_history)."""
        with self._lock:
            report, m = self._report, self._map
            diff = self._last_diff
            stats = dict(self._stats)
        if report is None or m is None:
            return
        pool_rows = [
            {"labels": {"pool": sk["name"]},
             "pool_shards": sk["shards"],
             "pool_max_deviation": round(sk["max_deviation"], 3),
             "pool_stddev": round(sk["stddev"], 3),
             "pool_score": round(sk["score"], 5)}
            for _pid, sk in sorted(report["pools"].items())
        ]
        osd_rows_ = [
            {"labels": {"osd": f"osd.{r['osd']}"},
             "osd_shards": r["shards"],
             "osd_primaries": r["primaries"],
             "osd_target": r["target"],
             "osd_deviation": r["deviation"]}
            for r in osd_rows(report, m)
        ]
        counters = {
            "placement": {
                "per_pool": {"__labeled__": True, "rows": pool_rows},
                "per_osd": {"__labeled__": True, "rows": osd_rows_},
                "epoch": report["epoch"],
                "scans": stats["scans"],
                "score": round(report["score"], 5),
                "max_deviation": round(report["max_deviation"], 3),
                "stddev": round(report["stddev"], 3),
                "imbalanced_pools": len(self.imbalanced()),
            },
            "remap": {
                "epochs_diffed": stats["epochs_diffed"],
                "pgs_remapped": stats["pgs_remapped_total"],
                "shards_remapped": stats["shards_remapped_total"],
                "predicted_bytes": stats["predicted_bytes_total"],
                "last_pgs_remapped": (diff or {}).get("pgs_remapped", 0),
                "last_shards_remapped":
                    (diff or {}).get("shards_remapped", 0),
                "last_predicted_bytes":
                    (diff or {}).get("predicted_bytes", 0),
                "last_misplaced_fraction": round(
                    (diff or {}).get("misplaced_fraction", 0.0), 6),
                "last_epoch": (diff or {}).get("to_epoch", 0),
            },
        }
        self.mgr.ingest_local_report("mgr.placement", counters,
                                     schema=_PLACEMENT_SCHEMA)

    def serve(self) -> None:
        interval = float(self.cct.conf.get("mgr_placement_interval"))
        # poll faster than the interval so an epoch change scans promptly
        poll = max(0.1, min(1.0, interval / 4.0))
        while not self._stop.is_set():
            self._stop.wait(timeout=poll)
            if self._stop.is_set():
                return
            try:
                self.tick()
            except KernelError:
                raise  # K3 did not build or launch: the module dies
            except Exception as e:
                # one torn map/report must not kill the loop
                self.cct.dout("mgr", 1, f"placement tick failed: {e!r}")


_PLACEMENT_SCHEMA = {
    "placement": {
        "per_pool": {"type": "labeled",
                     "description": "per-pool skew rows from the shared "
                                    "scoring core (osd/placement.py; "
                                    "docs/observability.md)"},
        "per_osd": {"type": "labeled",
                    "description": "per-OSD shard counts vs the "
                                   "weight-proportional ideal"},
        "pool_shards": {"type": "gauge",
                        "description": "placed PG shards in this pool"},
        "pool_max_deviation": {
            "type": "gauge",
            "description": "largest per-OSD deviation from the ideal "
                           "share in this pool (PG shards)"},
        "pool_stddev": {"type": "gauge",
                        "description": "stddev of per-OSD deviations in "
                                       "this pool (PG shards)"},
        "pool_score": {"type": "gauge",
                       "description": "normalized skew score (stddev / "
                                      "mean ideal share; 0 = perfect)"},
        "osd_shards": {"type": "gauge",
                       "description": "PG shards mapped to this OSD "
                                      "across pools (batched CRUSH scan)"},
        "osd_primaries": {"type": "gauge",
                          "description": "PGs whose primary is this OSD"},
        "osd_target": {"type": "gauge",
                       "description": "weight-proportional ideal shard "
                                      "share for this OSD"},
        "osd_deviation": {"type": "gauge",
                          "description": "shards minus target for this "
                                         "OSD (positive = overfull)"},
        "epoch": {"type": "gauge",
                  "description": "osdmap epoch of the last placement scan"},
        "scans": {"type": "u64",
                  "description": "full placement scans run (each = one "
                                 "batched crush_do_rule_batch launch per "
                                 "pool)"},
        "score": {"type": "gauge",
                  "description": "cluster-wide normalized skew score"},
        "max_deviation": {"type": "gauge",
                          "description": "largest per-OSD deviation "
                                         "cluster-wide (PG shards)"},
        "stddev": {"type": "gauge",
                   "description": "stddev of per-OSD deviations "
                                  "cluster-wide (PG shards)"},
        "imbalanced_pools": {
            "type": "gauge",
            "description": "pools over mgr_placement_max_deviation (the "
                           "PG_IMBALANCE inputs)"},
    },
    "remap": {
        "epochs_diffed": {"type": "u64",
                          "description": "osdmap epoch transitions "
                                         "forecast by the placement "
                                         "module"},
        "pgs_remapped": {"type": "u64",
                         "description": "cumulative PGs whose placement "
                                        "changed across observed epochs"},
        "shards_remapped": {"type": "u64",
                            "description": "cumulative PG shards "
                                           "remapped across observed "
                                           "epochs"},
        "predicted_bytes": {"type": "u64",
                            "description": "cumulative predicted "
                                           "bytes-to-move (shard byte "
                                           "weights from pool stats)"},
        "last_pgs_remapped": {"type": "gauge",
                              "description": "PGs remapped by the latest "
                                             "epoch transition"},
        "last_shards_remapped": {"type": "gauge",
                                 "description": "shards remapped by the "
                                                "latest epoch transition"},
        "last_predicted_bytes": {"type": "gauge",
                                 "description": "predicted bytes-to-move "
                                                "for the latest epoch "
                                                "transition"},
        "last_misplaced_fraction": {
            "type": "gauge",
            "description": "fraction of all placed shards the latest "
                           "epoch transition remapped (the remap-storm "
                           "forecast)"},
        "last_epoch": {"type": "gauge",
                       "description": "target epoch of the latest diff"},
    },
}
