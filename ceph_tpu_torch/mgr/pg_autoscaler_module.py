"""pg_autoscaler — per-pool PG-count tuning (reference:
src/pybind/mgr/pg_autoscaler/module.py; SURVEY.md §2.5 "other mgr
modules").

The reference's core loop: for each pool, a target PG count is computed
from the pool's share of cluster capacity times `mon_target_pg_per_osd`
times the OSD count, divided by the replication factor, rounded to a
power of two; a change is only applied when the current count is off by
more than a threshold factor (3x by default) so the autoscaler doesn't
thrash.  Shares come from observed bytes (daemon reports) with an equal
split as the prior for empty clusters — the reference uses pg_autoscale
bias/target_ratio the same way.

Applying a change issues `osd pool set <pool> pg_num <n>`; the OSDs then
run the split migration (osd/daemon.py _split_pass).  Only scale-UP is
applied (merges are rejected by the mon, matching this framework's
scope); scale-down recommendations are still reported.
"""
from __future__ import annotations

from .module import MgrModule, register_module


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


@register_module
class PgAutoscalerModule(MgrModule):
    NAME = "pg_autoscaler"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.last_eval: list[dict] = []
        self.passes = 0

    # -- the scale computation (reference: _get_pool_status) --------------
    def evaluate(self) -> list[dict]:
        m = self.get("osd_map")
        if m is None or not m.pools:
            return []
        n_osds = max(
            1, sum(1 for o in range(m.max_osd) if m.is_up(o) and m.is_in(o))
        )
        target_per_osd = self.cct.conf.get("mon_target_pg_per_osd")
        # byte shares from the freshest daemon stats; equal split when the
        # cluster is empty (the prior)
        stats = self.mgr.latest_stats()
        pool_bytes: dict[int, int] = {pid: 0 for pid in m.pools}
        for _daemon, s in stats.items():
            for pid_s, nbytes in (s.get("pool_bytes") or {}).items():
                pid = int(pid_s)
                if pid in pool_bytes:
                    pool_bytes[pid] += int(nbytes)
        total = sum(pool_bytes.values())
        out = []
        for pid, pool in m.pools.items():
            share = (
                pool_bytes[pid] / total if total > 0 else 1 / len(m.pools)
            )
            raw = share * target_per_osd * n_osds / max(1, pool.size)
            target = max(
                self.cct.conf.get("osd_pool_default_pg_num") // 4,
                _next_pow2(int(round(raw))),
            )
            factor = self.cct.conf.get("mgr_pg_autoscale_threshold")
            need = (
                target > pool.pg_num * factor
                or target * factor < pool.pg_num
            )
            out.append({
                "pool_id": pid,
                "pool": pool.name,
                "pg_num": pool.pg_num,
                "target": target,
                "share": round(share, 4),
                "would_adjust": bool(need),
            })
        self.last_eval = out
        return out

    def scale_once(self) -> list[dict]:
        applied = []
        for ev in self.evaluate():
            if not ev["would_adjust"] or ev["target"] <= ev["pg_num"]:
                continue  # only scale-up is actionable (mon rejects merges)
            rv, res = self.mon_command({
                "prefix": "osd pool set",
                "name": ev["pool"],
                "key": "pg_num",
                "value": ev["target"],
            })
            ev["applied"] = rv == 0
            ev["result"] = res
            if rv != 0:
                self.cct.dout(
                    "mgr", 1,
                    f"pg_autoscaler: pool {ev['pool']} -> "
                    f"{ev['target']} failed: {res}",
                )
            applied.append(ev)
        self.passes += 1
        return applied

    def serve(self) -> None:
        interval = self.cct.conf.get("mgr_pg_autoscale_interval")
        while not self._stop.wait(interval):
            try:
                if self.cct.conf.get("mgr_pg_autoscale_active"):
                    self.scale_once()
                else:
                    self.evaluate()
            except Exception as e:
                self.cct.dout("mgr", 1, f"pg_autoscaler failed: {e!r}")
