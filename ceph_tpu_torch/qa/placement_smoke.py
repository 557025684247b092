"""cephplace CI smoke: placement-plane observability end to end (the
port's counterpart of ceph_tpu/qa/placement_smoke.py).  The cluster and
the mgr's scans and balancer run on the device ``--device`` names
(``cuda`` by default: the batched placements on K3; ``cpu`` on request).

    python -m ceph_tpu_torch.qa.placement_smoke [--device cpu]

Drives the WHOLE surface through the production path, no shortcuts:

1. a LocalCluster (mgr hosted, replicated pool) with the placement
   module scanning on demand; ``ceph_placement_*`` series must render
   on the prometheus exporter;
2. one OSD is marked out mid-life: the placement module's epoch diff
   must FORECAST the remap, and the forecast must match the observed
   acting-set churn (`pg dump` up sets before vs after — the scalar
   mapping path, an independent implementation) within tolerance;
3. a deterministic imbalance is stacked via pg-upmap-items with the
   balancer off: ``PG_IMBALANCE`` must raise in `health`/`status`;
4. the balancer is activated and run: it must commit moves, the
   exported score must improve (score_after <= score_before, strict
   when moves committed), and ``PG_IMBALANCE`` must clear once the
   deviation converges under the bound;
5. `balancer status` and `placement diff` must answer over the mon
   command path.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

POOL = "placesmoke"
PG_NUM = 16
#: forecast-vs-observed agreement bound: both sides derive from the
#: same map epochs (batched vs scalar paths), so disagreement beyond
#: rounding means one path is wrong
TOLERANCE = 0.10


from .smoke_util import gauge as _gauge, scrape as _scrape, wait_for as _wait


def _up_sets(c, pool_id: int) -> dict[str, set[int]]:
    """{pgid: up-set} from `pg dump` — the mon's SCALAR mapping path,
    independent of the batched scan under test."""
    rv, dump = c.mon_command({"prefix": "pg dump"})
    if rv != 0:
        return {}
    return {
        r["pgid"]: {int(o) for o in r["up"] if int(o) >= 0}
        for r in dump.get("pg_stats", [])
        if r["pgid"].startswith(f"{pool_id}.")
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.placement_smoke",
        description="placement-plane observability end to end")
    ap.add_argument("--device", default="cuda",
                    help="the cluster's device (default: cuda)")
    args = ap.parse_args(argv)

    from ..common.device import resolve_device
    from ..qa.vstart import LocalCluster

    device = resolve_device(args.device)  # raises without a card

    problems: list[str] = []
    summary: dict = {}
    overrides = {
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.2,
        "mgr_placement_interval": 3600.0,   # scans driven by hand
        "mgr_balancer_interval": 3600.0,    # passes driven by hand
        "mgr_balancer_active": False,
    }
    with LocalCluster(n_mons=1, n_osds=4, with_mgr=True,
                      conf_overrides=overrides, device=device) as c:
        rv, res = c.mon_command({
            "prefix": "osd pool create", "name": POOL,
            "pg_num": PG_NUM, "size": 2,
        })
        if rv != 0:
            problems.append(f"pool create refused: {rv} {res}")
        pool_id = (res or {}).get("pool_id")
        c.mon_command({"prefix": "osd pool application enable",
                       "pool": POOL, "app": "rados"})
        io = c.client().open_ioctx(POOL)
        for i in range(8):
            io.write_full(f"ob{i}", bytes([i + 1]) * 4096)
        pm = c.mgr.module("placement")
        if not _wait(lambda: c.mgr.mc.osdmap is not None
                     and pool_id in c.mgr.mc.osdmap.pools, 15.0):
            problems.append("mgr never saw the pool")

        # -- 1. series render on the exporter --------------------------
        url = c.mgr.module("prometheus").url
        pm.scan()
        wanted = ("ceph_placement_pool_score",
                  "ceph_placement_osd_deviation",
                  "ceph_remap_epochs_diffed", "ceph_balancer_passes")
        if not _wait(lambda: all(m in _scrape(url) for m in wanted),
                     15.0):
            body = _scrape(url)
            problems.append("placement series never rendered: missing "
                            + ", ".join(m for m in wanted
                                        if m not in body))

        # -- 2. forecast vs observed churn on an osd-out ---------------
        pm.scan()  # prime the previous-epoch mapping cache
        before = _up_sets(c, pool_id)
        victim = 3
        rv, res = c.mon_command({"prefix": "osd out", "id": victim})
        if rv != 0:
            problems.append(f"osd out refused: {rv} {res}")
        if not _wait(lambda: not c.mgr.mc.osdmap.is_in(victim), 10.0):
            problems.append("mgr never saw the out epoch")
        out_epoch = c.mgr.mc.osdmap.epoch
        pm.scan()
        after = _up_sets(c, pool_id)
        observed_pgs = observed_shards = 0
        for pgid, b in after.items():
            new = b - before.get(pgid, set())
            if new:
                observed_pgs += 1
                observed_shards += len(new)

        # the mon serves `placement diff` from the mgr's PUSHED digest
        # (refreshed every mgr_digest_interval), so the forecast lands
        # asynchronously after the scan — poll until the digest carries
        # a diff covering the out epoch
        def _mon_diff():
            rv2, pd2 = c.mon_command({"prefix": "placement diff"})
            d2 = (pd2 or {}).get("diff") if rv2 == 0 else None
            if d2 and d2.get("to_epoch", 0) >= out_epoch:
                return d2
            return None

        box: dict = {}
        _wait(lambda: box.update(d=_mon_diff()) or box["d"], 10.0)
        diff = box.get("d")
        if not diff:
            rv, pd = c.mon_command({"prefix": "placement diff"})
            problems.append(f"`placement diff` carried no forecast for "
                            f"epoch >= {out_epoch}: {rv} {pd}")
        else:
            fc_pgs = diff.get("pgs_remapped", 0)
            fc_shards = diff.get("shards_remapped", 0)
            summary["forecast"] = {
                "pgs": fc_pgs, "shards": fc_shards,
                "misplaced_fraction": diff.get("misplaced_fraction"),
                "predicted_bytes": diff.get("predicted_bytes"),
            }
            summary["observed"] = {"pgs": observed_pgs,
                                   "shards": observed_shards}
            if observed_pgs == 0:
                problems.append("marking an OSD out remapped nothing "
                                "(scenario broken)")
            else:
                for what, fc, ob in (("pgs", fc_pgs, observed_pgs),
                                     ("shards", fc_shards,
                                      observed_shards)):
                    if abs(fc - ob) > max(1, TOLERANCE * ob):
                        problems.append(
                            f"forecast {what} {fc} vs observed {ob} "
                            f"beyond {TOLERANCE:.0%} tolerance")

        # -- 3. deterministic imbalance raises PG_IMBALANCE ------------
        m = c.mgr.mc.osdmap
        stacked = 0
        up0, _ = m.map_pool(pool_id)
        for ps in range(PG_NUM):
            row = [int(o) for o in up0[ps] if int(o) >= 0]
            if 0 in row or not row:
                continue
            rv, res = c.mon_command({
                "prefix": "osd pg-upmap-items", "pool": pool_id,
                "ps": ps, "mappings": [[row[-1], 0]],
            })
            if rv == 0:
                stacked += 1
        summary["stacked_upmaps"] = stacked
        if not stacked:
            problems.append("could not stack any upmap imbalance")
        if not _wait(lambda: len(c.mgr.mc.osdmap.pg_upmap_items)
                     >= stacked, 10.0):
            problems.append("mgr never saw the stacked upmaps")
        rep = pm.scan()
        d0 = rep["max_deviation"] if rep else 0.0
        summary["stacked_max_deviation"] = round(d0, 2)
        c.mgr.cct.conf.set("mgr_placement_max_deviation",
                           max(0.5, d0 - 1.0))
        pm.scan()

        def check_state():
            rv2, st = c.mon_command({"prefix": "status"})
            if rv2 != 0:
                return None
            return (st.get("health") or {}).get("checks") or {}

        if not _wait(lambda: "PG_IMBALANCE" in (check_state() or {}),
                     10.0):
            problems.append(
                f"PG_IMBALANCE never raised (max_deviation {d0})")

        # -- 4. balancer run improves the exported score, check clears -
        # the balancer refuses a degraded cluster (upstream parity), and
        # the out-osd + stacked-upmap remaps above leave objects
        # degraded until recovery lands them — settle first, as an
        # operator balancing a live cluster would
        try:
            c.wait_clean(POOL, timeout=30)
        except TimeoutError:
            problems.append("pool never settled after the stacked "
                            "upmaps; balancer phase would be refused")
        c.mgr.cct.conf.set("mgr_balancer_active", True)
        bal = c.mgr.module("balancer")
        bal.optimize_once()
        if (bal.status().get("last_skip") or {}).get("reason"):
            # lingering stale degraded rows can outlive wait_clean by a
            # report cycle — give the gate a moment and retry once
            _wait(lambda: bal.optimize_once() or bal.status()["passes"],
                  10.0)
        st = bal.status()
        lp = st.get("last_pass") or {}
        summary["balancer"] = {
            "proposed": lp.get("proposed"),
            "committed": lp.get("committed"),
            "failed": lp.get("failed"),
            "score_before": (lp.get("score_before") or {}).get("score"),
            "score_after": (lp.get("score_after") or {}).get("score"),
        }
        if not lp.get("committed"):
            problems.append(f"balancer committed no moves against a "
                            f"stacked imbalance: {lp}")
        if st.get("balancer_errors"):
            problems.append(f"balancer commit errors: "
                            f"{st.get('last_error')}")
        sb = (lp.get("score_before") or {}).get("score", 0.0)
        sa = (lp.get("score_after") or {}).get("score", 0.0)
        if sa > sb or (lp.get("committed") and not sa < sb):
            problems.append(
                f"balancer pass did not improve the score: "
                f"{sb} -> {sa}")
        # the exported gauges must carry the same story
        if not _wait(lambda: (_gauge(_scrape(url),
                                     "ceph_balancer_moves_committed")
                              or 0) > 0, 10.0):
            problems.append("ceph_balancer_moves_committed never "
                            "rendered > 0")
        body = _scrape(url)
        exp_b = _gauge(body, "ceph_balancer_score_before")
        exp_a = _gauge(body, "ceph_balancer_score_after")
        summary["exported_scores"] = {"before": exp_b, "after": exp_a}
        if exp_b is None or exp_a is None or exp_a > exp_b:
            problems.append(f"exported balancer scores wrong: "
                            f"{exp_b} -> {exp_a}")
        # wait for the committed upmaps to land, rescan, clear the check
        if not _wait(lambda: pm.scan() is not None
                     and pm.snapshot()["cluster"]["max_deviation"] < d0,
                     15.0):
            problems.append("deviation never improved after the "
                            "balancer pass")
        d1 = pm.snapshot()["cluster"]["max_deviation"]
        summary["balanced_max_deviation"] = round(d1, 2)
        c.mgr.cct.conf.set("mgr_placement_max_deviation", d1 + 0.5)
        pm.scan()
        if not _wait(lambda: "PG_IMBALANCE" not in (check_state() or {}),
                     10.0):
            problems.append("PG_IMBALANCE never cleared after "
                            "convergence")

        # -- 5. balancer status over the mon path ----------------------
        rv, bs = c.mon_command({"prefix": "balancer status"})
        if rv != 0 or not bs.get("passes"):
            problems.append(f"`balancer status` broken: {rv} {bs}")
        else:
            summary["balancer_status_passes"] = bs["passes"]

    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
