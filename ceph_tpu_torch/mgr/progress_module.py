"""progress — recovery/backfill progress events (reference:
src/pybind/mgr/progress/module.py: the mgr module that turns PG state
churn into named events with a completion fraction, served as `ceph
progress` and the one-line recovery bar in `ceph status`).

The cephheal wiring: every OSD's ``_mgr_report`` now ships per-PG
``degraded``/``misplaced``/``objects`` counts inside ``pg_info``.  The
:class:`ProgressTracker` (pure, synthesizable in tests) folds a time
series of those snapshots into per-PG recovery events:

- a PG first seen with ``degraded > 0`` opens an event whose baseline
  is the LARGEST degraded count seen (so the fraction is monotone even
  while more peers report in);
- ``progress = 1 - degraded / baseline``, clamped monotone;
- the ETA divides the remaining count by an exponentially smoothed
  drain rate;
- a PG back at ``degraded == 0`` completes its event (kept briefly for
  `ceph progress` display);
- a PG degraded with ~zero drain past ``mgr_recovery_stalled_grace``
  seconds — while the cluster-wide recovery-op rate
  (``metrics_history.rate("osd.recovery_ops")``) is also ~zero — is
  STALLED: the mon raises RECOVERY_STALLED naming it (plus any PG whose
  recovery pass raises every tick, the OSDs' ``recovery_failing``
  reports).

The module's snapshot rides the status module's mon digest, so the mon
answers the ``progress`` command and renders the status bar without a
channel to the mgr (the `perf history` precedent).
"""
from __future__ import annotations

import time

from ..common.lockdep import make_lock
from .module import MgrModule, register_module

#: completed events kept for display
_MAX_DONE = 32
#: drain-rate smoothing factor (EMA; higher = snappier ETA)
_RATE_ALPHA = 0.3


class _Event:
    __slots__ = ("pgid", "started", "baseline", "current", "rate",
                 "last_ts", "last_improve_ts", "best_fraction")

    def __init__(self, pgid: str, ts: float, degraded: int):
        self.pgid = pgid
        self.started = ts
        self.baseline = degraded
        self.current = degraded
        self.rate = 0.0           # objects/s drained, smoothed
        self.last_ts = ts
        self.last_improve_ts = ts
        self.best_fraction = 0.0  # monotone display clamp

    def fraction(self) -> float:
        """Monotone by contract: a mid-recovery regression (a second
        failure raising degraded again without exceeding the baseline)
        must not walk the `ceph status` bar backward — the raw fraction
        is clamped to the best seen."""
        if self.baseline <= 0:
            return 1.0
        raw = max(0.0, min(1.0, 1.0 - self.current / self.baseline))
        self.best_fraction = max(self.best_fraction, raw)
        return self.best_fraction

    def eta_seconds(self) -> float | None:
        if self.rate <= 1e-9 or self.current <= 0:
            return None
        return self.current / self.rate


class ProgressTracker:
    """Pure fold: (ts, {pgid: degraded}, recovery_rate) snapshots ->
    events/completed/stalled.  No clock reads of its own, so tests
    drive it with synthetic timestamps."""

    def __init__(self, stalled_grace: float = 10.0):
        self.stalled_grace = stalled_grace
        self._events: dict[str, _Event] = {}
        self._done: list[dict] = []
        self._recovery_rate = 0.0

    def update(self, ts: float, pg_degraded: dict[str, int],
               recovery_rate: float = 0.0) -> None:
        self._recovery_rate = recovery_rate
        for pgid, degraded in pg_degraded.items():
            degraded = max(0, int(degraded))
            ev = self._events.get(pgid)
            if ev is None:
                if degraded > 0:
                    self._events[pgid] = _Event(pgid, ts, degraded)
                continue
            dt = ts - ev.last_ts
            if degraded > ev.baseline:
                # more peers reported in: grow the baseline so the
                # fraction stays monotone instead of jumping backward
                ev.baseline = degraded
            if degraded < ev.current:
                drained = ev.current - degraded
                if dt > 0:
                    inst = drained / dt
                    ev.rate = (inst if ev.rate <= 0 else
                               _RATE_ALPHA * inst
                               + (1 - _RATE_ALPHA) * ev.rate)
                ev.last_improve_ts = ts
            elif degraded > ev.current:
                # a regression (second failure mid-recovery) restarts
                # the stall clock — recovery just got MORE to do, it is
                # not stuck the instant the new failure lands
                ev.last_improve_ts = ts
            ev.current = degraded
            ev.last_ts = ts
            if degraded == 0:
                self._done.append({
                    "pgid": pgid,
                    "message": f"recovery of pg {pgid}",
                    "progress": 1.0,
                    "started": ev.started,
                    "finished": ts,
                    "duration": round(ts - ev.started, 3),
                })
                del self._done[:-_MAX_DONE]
                del self._events[pgid]
        # a PG that vanished from the reports (pool deleted, primary
        # gone silent) must not sit at 60% forever
        for pgid in [p for p in self._events if p not in pg_degraded]:
            ev = self._events[pgid]
            if ts - ev.last_ts > 4 * max(self.stalled_grace, 1.0):
                del self._events[pgid]

    def events(self) -> list[dict]:
        out = []
        for ev in self._events.values():
            eta = ev.eta_seconds()
            out.append({
                "pgid": ev.pgid,
                "message": f"recovery of pg {ev.pgid}",
                "progress": round(ev.fraction(), 4),
                "degraded": ev.current,
                "baseline": ev.baseline,
                "rate_objects_per_sec": round(ev.rate, 3),
                "eta_seconds": None if eta is None else round(eta, 1),
                "started": ev.started,
            })
        return sorted(out, key=lambda e: e["pgid"])

    def completed(self) -> list[dict]:
        return list(self._done)

    def stalled(self, now: float) -> list[dict]:
        """PGs degraded with no drain past the grace while the cluster
        recovers ~nothing — the RECOVERY_STALLED inputs."""
        if self._recovery_rate > 0.1:
            return []
        out = []
        for ev in self._events.values():
            if ev.current > 0 and \
                    now - ev.last_improve_ts >= self.stalled_grace:
                out.append({
                    "pgid": ev.pgid,
                    "degraded": ev.current,
                    "stalled_for": round(now - ev.last_improve_ts, 1),
                })
        return sorted(out, key=lambda e: -e["degraded"])


@register_module
class ProgressModule(MgrModule):
    """The host loop: poll the OSDs' pg_info snapshots on
    ``mgr_progress_interval``, feed the tracker, export ceph_progress_*
    series, and hand the status module its digest section."""

    NAME = "progress"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._lock = make_lock("mgr::progress")
        self.tracker = ProgressTracker(
            stalled_grace=float(
                self.cct.conf.get("mgr_recovery_stalled_grace")))

    def _pg_degraded(self) -> dict[str, int]:
        """{pgid: degraded} via the mgr's shared freshest-wins pg_info
        merge (also the balancer's degraded-gate input)."""
        return self.mgr.pg_degraded_by_pgid()

    def _recovery_failing(self) -> dict[str, dict]:
        """{pgid: {count, error, daemon}} union of the OSDs'
        repeat-failing recovery reports."""
        out: dict[str, dict] = {}
        for daemon, st in self.mgr.latest_stats().items():
            for pgid, rec in (st.get("recovery_failing") or {}).items():
                out[pgid] = {**rec, "daemon": daemon}
        return out

    def tick(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        stale = float(self.cct.conf.get("mgr_stale_report_age"))
        rate = sum((self.mgr.metrics_history.rate(
            "osd.recovery_ops", max_age=stale) or {}).values())
        with self._lock:
            self.tracker.stalled_grace = float(
                self.cct.conf.get("mgr_recovery_stalled_grace"))
            self.tracker.update(now, self._pg_degraded(), rate)
        self.export(now, rate)

    def snapshot(self, now: float | None = None) -> dict:
        """The `ceph progress` payload / digest section."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                "events": self.tracker.events(),
                "completed": self.tracker.completed(),
                "stalled": self.tracker.stalled(now),
                "failing": self._recovery_failing(),
            }

    def export(self, now: float, recovery_rate: float) -> None:
        """ceph_progress_* series through the mgr's own report sink
        (prometheus + metrics_history — the qos-module precedent)."""
        with self._lock:
            events = self.tracker.events()
            stalled = self.tracker.stalled(now)
        counters = {"progress": {
            "events_active": len(events),
            "objects_degraded": sum(e["degraded"] for e in events),
            "recovery_rate": round(recovery_rate, 3),
            "stalled_pgs": len(stalled),
        }}
        self.mgr.ingest_local_report("mgr.progress", counters,
                                     schema=_PROGRESS_SCHEMA)

    def serve(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(timeout=float(
                self.cct.conf.get("mgr_progress_interval")))
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception as e:
                # one torn report must not kill the loop
                self.cct.dout("mgr", 1, f"progress tick failed: {e!r}")


_PROGRESS_SCHEMA = {"progress": {
    "events_active": {"type": "gauge",
                      "description": "PG recovery/backfill events in "
                                     "flight"},
    "objects_degraded": {"type": "gauge",
                         "description": "object-copies currently "
                                        "degraded across tracked "
                                        "events"},
    "recovery_rate": {"type": "gauge",
                      "description": "cluster recovery push rate "
                                     "(objects/s, from "
                                     "metrics_history.rate)"},
    "stalled_pgs": {"type": "gauge",
                    "description": "degraded PGs with ~zero drain past "
                                   "mgr_recovery_stalled_grace"},
}}
