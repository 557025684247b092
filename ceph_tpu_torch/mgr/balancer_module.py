"""Balancer module — periodic upmap optimization (reference:
src/pybind/mgr/balancer/module.py upmap mode: propose OSDMap::calc_pg_upmaps
fills against the current map, commit via mon commands; `balancer eval` /
`balancer status` are the upstream introspection surfaces mirrored here).

The placement math itself is the batched-CRUSH library routine
(osd/balancer.py :: calc_pg_upmaps — one batched mapping per pool a pass,
K3 on the card);
this module is the daemon loop driving it against the LIVE map.

cephplace un-blinding: every pass is a first-class observed operation —
pre/post skew scores from the shared scoring core (the `balancer eval`
analog), proposed/committed/failed move counts, a bounded score
trajectory, `balancer` tracepoints per pass and per commit failure,
``ceph_balancer_*`` prometheus series, and a snapshot riding the status
digest so the mon answers `balancer status`.  Failed `osd
pg-upmap-items` commits COUNT (``balancer_errors`` + ``last_error``)
instead of scrolling away at dout level 1."""
from __future__ import annotations

import copy
import time

from ..common.lockdep import make_lock
from ..common.tracer import TRACER
from ..ops.nvcc import KernelError
from ..osd.balancer import calc_pg_upmaps
from ..osd.placement import cluster_report
from .module import MgrModule, register_module

#: score-trajectory samples kept for `balancer status`
_MAX_SCORES = 64


def _scores(report: dict) -> dict:
    return {"score": round(report["score"], 4),
            "max_deviation": round(report["max_deviation"], 2),
            "stddev": round(report["stddev"], 2)}


@register_module
class BalancerModule(MgrModule):
    NAME = "balancer"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._lock = make_lock("mgr::balancer")
        self.last_result: list = []
        self.passes = 0
        self._stats = {"moves_proposed": 0, "moves_committed": 0,
                       "commits_failed": 0, "balancer_errors": 0,
                       "passes_skipped": 0}
        self._last_error: str | None = None
        self._last_pass: dict = {}
        self._last_skip: dict = {}
        self._score_trajectory: list[dict] = []

    def _unclean_reason(self) -> str | None:
        """Upstream parity (mgr balancer Module.optimize refuses while
        objects are degraded): an upmap commit mid-recovery retargets
        acting sets under the recovering PGs."""
        try:
            merged = self.mgr.pg_degraded_by_pgid()
        except Exception:
            return None  # fail open: a bare test mgr carries no stats
        deg = sum(merged.values())
        if deg:
            pgs = sum(1 for v in merged.values() if v)
            return f"{deg} object(s) degraded across {pgs} pg(s)"
        return None

    def optimize_once(self) -> list[tuple[int, int, int, int]]:
        """One balance pass: propose on a scratch copy of the live map,
        commit each change as `osd pg-upmap-items` (the reference commits
        an inc map the same way)."""
        m = self.get("osd_map")
        if m is None or not m.pools:
            # nothing to score or move — and no O(map) deepcopy either.
            # Still export: the series are guaranteed from boot, and a
            # report older than mgr_stale_report_age drops off the
            # exporter — idling must not unpublish them
            self.export()
            return []
        unclean = self._unclean_reason()
        if unclean is not None:
            # the skip is itself observed (`balancer status` last_skip,
            # `balancer_passes_skipped`, `balancer` tracepoint); the
            # pass counter stays still, so PG_IMBALANCE's idle-balancer
            # rule sees an idle balancer
            with self._lock:
                self._last_skip = {"ts": time.monotonic(),
                                   "reason": unclean}
                self._stats["passes_skipped"] += 1
            TRACER.tracepoint("balancer", "skipped", entity="mgr",
                              reason=unclean)
            self.export()
            return []
        scratch = copy.deepcopy(m)
        # pre/post skew from the shared core: ONE batched sweep of the
        # pre-change scratch feeds both the pre score and the greedy
        # loop; only the post score re-maps (the upmaps changed) — the
        # `balancer eval` pair at two sweeps per pass, not three
        mappings = {pid: scratch.map_pool(pid)
                    for pid in sorted(scratch.pools)}
        pre = _scores(cluster_report(scratch, mappings=mappings))
        changes = calc_pg_upmaps(scratch, mappings=mappings)
        active = bool(self.cct.conf.get("mgr_balancer_active"))
        committed = failed = 0
        last_error = None
        failed_keys: set[tuple[int, int]] = set()
        # moves per PG: one mon command carries a pg's full pair list,
        # but committed/failed count MOVES so they share units with
        # `proposed` (a 2-move PG must not render as 2 proposed /
        # 1 committed / 0 errors)
        per_pg: dict[tuple[int, int], int] = {}
        for pool_id, ps, _from, _to in changes:
            per_pg[(pool_id, ps)] = per_pg.get((pool_id, ps), 0) + 1
        if active:
            for (pool_id, ps), n_moves in per_pg.items():
                pairs = scratch.pg_upmap_items.get((pool_id, ps), [])
                rv, res = self.mon_command({
                    "prefix": "osd pg-upmap-items",
                    "pool": pool_id,
                    "ps": ps,
                    "mappings": [list(p) for p in pairs],
                })
                if rv != 0:
                    failed += n_moves
                    failed_keys.add((pool_id, ps))
                    last_error = (f"pg-upmap-items {pool_id}.{ps:x} "
                                  f"refused: {rv} {res}")
                    self.cct.dout(
                        "mgr", 1, f"balancer: upmap commit failed: {res}"
                    )
                    TRACER.tracepoint(
                        "balancer", "commit_failed", entity="mgr",
                        pg=f"{pool_id}.{ps:x}", retval=rv,
                        error=str(res)[:200])
                else:
                    committed += n_moves
        # score_after describes what LANDED: roll refused commits back
        # off the scratch map before re-scoring (a mon that refuses
        # every move must not export a converging score).  In dry-run
        # the full proposal is scored — the `balancer eval` semantics.
        for key in failed_keys:
            orig = m.pg_upmap_items.get(key)
            if orig is None:
                scratch.pg_upmap_items.pop(key, None)
            else:
                scratch.pg_upmap_items[key] = [tuple(p) for p in orig]
        landed = committed if active else len(changes)
        post = _scores(cluster_report(scratch)) if landed else dict(pre)
        with self._lock:
            self.last_result = changes
            self.passes += 1
            n_pass = self.passes
            self._stats["moves_proposed"] += len(changes)
            self._stats["moves_committed"] += committed
            self._stats["commits_failed"] += failed
            # error EVENTS (one per refused command), not failed moves
            self._stats["balancer_errors"] += len(failed_keys)
            if last_error is not None:
                self._last_error = last_error
            self._last_pass = {
                "ts": time.monotonic(),
                "active": active,
                "proposed": len(changes),
                "committed": committed,
                "failed": failed,
                "score_before": pre,
                "score_after": post,
            }
            self._score_trajectory.append(
                {"pass": n_pass, "before": pre["score"],
                 "after": post["score"]})
            del self._score_trajectory[:-_MAX_SCORES]
        TRACER.tracepoint(
            "balancer", "pass", entity="mgr", n=n_pass, active=active,
            proposed=len(changes), committed=committed, failed=failed,
            score_before=pre["score"], score_after=post["score"],
            max_deviation_before=pre["max_deviation"],
            max_deviation_after=post["max_deviation"])
        self.export()
        return changes

    # -- introspection -------------------------------------------------------
    def last_pass(self) -> dict:
        with self._lock:
            return dict(self._last_pass)

    def status(self) -> dict:
        """The `balancer status` payload / digest section (JSON-safe):
        passes, move outcomes, score trajectory, last error."""
        now = time.monotonic()
        with self._lock:
            lp = dict(self._last_pass)
            ls = dict(self._last_skip)
            out = {
                "active": bool(self.cct.conf.get("mgr_balancer_active")),
                "passes": self.passes,
                **dict(self._stats),
                "last_error": self._last_error,
                "last_pass": lp or None,
                "last_skip": ls or None,
                "score_trajectory": list(self._score_trajectory[-16:]),
            }
        if lp:
            out["last_pass_age_seconds"] = round(now - lp["ts"], 1)
        if ls:
            out["last_skip_age_seconds"] = round(now - ls["ts"], 1)
        return out

    def export(self) -> None:
        """ceph_balancer_* series through the mgr's own report sink."""
        with self._lock:
            lp = self._last_pass
            counters = {"balancer": {
                "passes": self.passes,
                "passes_skipped": self._stats["passes_skipped"],
                "moves_proposed": self._stats["moves_proposed"],
                "moves_committed": self._stats["moves_committed"],
                "balancer_errors": self._stats["balancer_errors"],
                "active": int(bool(
                    self.cct.conf.get("mgr_balancer_active"))),
                "last_proposed": lp.get("proposed", 0),
                "last_committed": lp.get("committed", 0),
                "score_before": (lp.get("score_before") or {}).get(
                    "score", 0.0),
                "score_after": (lp.get("score_after") or {}).get(
                    "score", 0.0),
                "max_deviation_after": (lp.get("score_after") or {}).get(
                    "max_deviation", 0.0),
            }}
        self.mgr.ingest_local_report("mgr.balancer", counters,
                                     schema=_BALANCER_SCHEMA)

    def serve(self) -> None:
        interval = self.cct.conf.get("mgr_balancer_interval")
        try:
            # the series must exist from boot, not from the first pass
            # (a dashboard scraping a freshly-started idle balancer)
            self.export()
        except Exception as e:
            self.cct.dout("mgr", 3, f"balancer boot export failed: {e!r}")
        while not self._stop.wait(interval):
            try:
                self.optimize_once()
            except KernelError:
                # balancer_errors counts refused commits and torn maps,
                # not a kernel that did not build or launch
                raise
            except Exception as e:
                with self._lock:
                    self._stats["balancer_errors"] += 1
                    self._last_error = f"pass raised: {e!r}"
                self.cct.dout("mgr", 1, f"balancer pass failed: {e!r}")
                try:
                    # the error counter is the alertable surface — it
                    # must move even when the pass never reached export
                    self.export()
                except Exception as e2:
                    self.cct.dout("mgr", 3,
                                  f"balancer error export failed: {e2!r}")


_BALANCER_SCHEMA = {"balancer": {
    "passes": {"type": "u64", "description": "balancer passes run"},
    "passes_skipped": {"type": "u64",
                       "description": "passes refused against a "
                                      "degraded cluster (reason in "
                                      "`balancer status` last_skip)"},
    "moves_proposed": {"type": "u64",
                       "description": "upmap moves calc_pg_upmaps "
                                      "proposed across passes"},
    "moves_committed": {"type": "u64",
                        "description": "upmap moves the mon accepted "
                                       "(same units as moves_proposed; "
                                       "one pg-upmap-items command may "
                                       "carry several)"},
    "balancer_errors": {"type": "u64",
                        "description": "error events: refused "
                                       "pg-upmap-items commands + raised "
                                       "passes (details in `balancer "
                                       "status` last_error)"},
    "active": {"type": "gauge",
               "description": "1 = commits moves; 0 = dry-run "
                              "(mgr_balancer_active)"},
    "last_proposed": {"type": "gauge",
                      "description": "moves proposed by the latest pass"},
    "last_committed": {"type": "gauge",
                       "description": "moves committed by the latest "
                                      "pass"},
    "score_before": {"type": "gauge",
                     "description": "normalized skew score before the "
                                    "latest pass (shared scoring core; "
                                    "0 = perfect)"},
    "score_after": {"type": "gauge",
                    "description": "normalized skew score after the "
                                   "latest pass"},
    "max_deviation_after": {"type": "gauge",
                            "description": "largest per-OSD deviation "
                                           "(PG shards) after the "
                                           "latest pass"},
}}
