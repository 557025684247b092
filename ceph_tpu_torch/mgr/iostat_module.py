"""iostat module — cluster IO rates from the shared metrics-history
store (reference: src/pybind/mgr/iostat/module.py feeding `ceph
iostat`: rd/wr ops and bytes per second computed between consecutive
daemon reports).

cephmeter refactor: the module used to hand-roll its own
``_prev`` delta tracking over ``latest_reports_with_ts``; that private
value history is gone — the DATA lives in ``mgr.metrics_history``, the
same bounded ring every other history consumer (the `perf history`
command, future QoS controllers) queries.  The module keeps only a
per-daemon poll CURSOR (the newest sample ts it saw last time) so the
old semantics survive the refactor: a rate covers everything since the
previous ``sample()`` call — a counter burst between two polls is never
missed — deltas divide by report ARRIVAL intervals, counter resets
clamp to 0, and dead daemons drop out via the staleness filter (hidden
from output immediately; the store forgets their series — and this
module their cursors — after the store's ``forget_age``)."""
from __future__ import annotations

from .module import MgrModule, register_module

_RATE_COUNTERS = ("op", "op_r", "op_w", "op_r_bytes", "op_w_bytes")


@register_module
class IostatModule(MgrModule):
    NAME = "iostat"

    def __init__(self, mgr):
        super().__init__(mgr)
        # daemon -> newest history-sample ts consumed by the previous
        # sample() call (a cursor into the SHARED store, not a value
        # copy — the first call primes it and reports zeros, like
        # `iostat`'s since-boot first line the reference also skips)
        self._cursor: dict[str, float] = {}

    def sample(self) -> dict:
        """Cluster-wide rates since the PREVIOUS sample() call, from
        the shared metrics-history store."""
        h = self.mgr.metrics_history
        max_age = self.cct.conf.get("mgr_stale_report_age")
        totals = {c: 0.0 for c in _RATE_COUNTERS}
        per_daemon: dict[str, dict] = {}
        seen: dict[str, float] = {}
        for c in _RATE_COUNTERS:
            rates = h.rate_since(f"osd.{c}", self._cursor,
                                 max_age=max_age)
            for daemon, (r, ts) in rates.items():
                seen[daemon] = max(ts, seen.get(daemon, 0.0))
                if r is None:
                    continue  # priming: cursor set, rate next poll
                per_daemon.setdefault(daemon, {})[c] = r
                totals[c] += r
        # advance cursors for daemons with fresh reports.  A daemon
        # rate_since omitted this poll (nothing new yet, or briefly
        # stale) keeps its cursor — if it returns after a restart the
        # reset-clamp yields one 0 rate and the next poll is clean;
        # one the STORE has forgotten (silent past forget_age) loses
        # its cursor too, so _cursor cannot grow without bound under
        # daemon churn
        for daemon, ts in seen.items():
            self._cursor[daemon] = ts
        live = set(h.daemons())
        for gone in set(self._cursor) - live:
            del self._cursor[gone]
        for rates in per_daemon.values():
            for c in _RATE_COUNTERS:
                rates.setdefault(c, 0.0)
        return {
            "ops_per_s": round(totals["op"], 1),
            "rd_ops_per_s": round(totals["op_r"], 1),
            "wr_ops_per_s": round(totals["op_w"], 1),
            "rd_bytes_per_s": round(totals["op_r_bytes"], 1),
            "wr_bytes_per_s": round(totals["op_w_bytes"], 1),
            "daemons": per_daemon,
        }
