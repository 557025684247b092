"""Quota module — stats-driven pool FULL_QUOTA flagging (reference: the
monitor's stats-driven pool quota enforcement in OSDMonitor — upstream
compares pg stats to quota_max_bytes/objects and sets FLAG_FULL_QUOTA;
here cluster stats live in the mgr, so the mgr runs the comparison and
flips the flag through a mon command).

Byte accounting note: daemon reports carry RAW stored bytes (all
replicas / all EC shards).  The comparison divides by the pool's
redundancy factor (size for replicated, (k+m)/k for EC) to approximate
the LOGICAL bytes a quota intuitively bounds, matching the reference's
num_bytes semantics.  Enforcement is eventually-consistent with the
report interval, like the reference's stats-lag window.
"""
from __future__ import annotations

import time

from .module import MgrModule, register_module


@register_module
class QuotaModule(MgrModule):
    NAME = "quota"

    def serve(self) -> None:
        interval = float(self.cct.conf.get("mgr_quota_interval"))
        while not self._stop.wait(timeout=interval):
            try:
                self.enforce_once()
            except Exception as e:
                self.cct.dout("mgr", 3, f"quota pass failed: {e!r}")

    def pool_usage(self) -> dict[int, dict]:
        """{pool_id: {"bytes": logical_estimate, "objects": n}} from the
        freshest daemon reports."""
        from .status_module import pool_usage

        return pool_usage(self.get("osd_map"), self.mgr.latest_stats())

    def enforce_once(self) -> list[str]:
        """Compare usage to quotas; flip full_quota where the state
        changed.  Returns the pools whose flag flipped."""
        m = self.get("osd_map")
        if m is None:
            return []
        usage = self.pool_usage()
        flipped = []
        for pid, pool in m.pools.items():
            if not (pool.quota_max_bytes or pool.quota_max_objects):
                continue
            u = usage.get(pid, {"bytes": 0, "objects": 0})
            over = (
                (pool.quota_max_bytes
                 and u["bytes"] >= pool.quota_max_bytes)
                or (pool.quota_max_objects
                    and u["objects"] >= pool.quota_max_objects)
            )
            have = "full_quota" in getattr(pool, "flags", ())
            if bool(over) != have:
                rv, _res = self.mon_command({
                    "prefix": "osd pool quota-flag",
                    "name": pool.name, "full": int(bool(over)),
                })
                if rv == 0:
                    flipped.append(pool.name)
        return flipped
