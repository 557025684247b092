"""metrics_history — the mgr's bounded time-series ring (reference:
the PGMap/ClusterState history the reference mgr keeps for `ceph
iostat` and the prometheus module's self-queries; cephmeter).

Every incoming ``MMgrReport`` lands one sample per numeric counter into
a per-(daemon, series) ring — fed synchronously from
``MgrDaemon.ms_dispatch``, so there is no polling race and the sample
timestamp IS the report's arrival time (rates must divide by the report
interval, not a caller's cadence).  The store is the "controller reads
its own Prometheus series" substrate from the ROADMAP's closed-loop QoS
item: anything hosted by the mgr (iostat, a future batch-window tuner)
queries ``series()``/``rate()`` instead of hand-rolling private delta
tracking.

Bounds: ``mgr_metrics_history_samples`` per series,
``mgr_metrics_history_max_series`` series total (overflow is dropped
and counted — a runaway-cardinality daemon cannot eat the mgr).

Series names are ``"<subsystem>.<counter>"``; histogram counters
contribute ``<name>.count``/``<name>.sum`` sub-series and longrunavg
counters ``<name>.avgcount``/``<name>.sum`` (both rate-able).  Labeled
row structures (the ``client_io`` accounting table) stay on the
prometheus path — flattening per-client rows here would defeat the
series cap.

The ``metrics_history`` mgr module is the query surface; a compact
``digest()`` snapshot rides the status module's MMonMgrReport digest so
the mon can answer the ``perf history`` CLI command without talking to
the mgr.
"""
from __future__ import annotations

from collections import deque

from ..common.lockdep import make_lock
from .module import MgrModule, register_module

#: the series the mon-facing digest snapshot carries (the `ceph perf
#: history` surface — iostat's rate counters, the cluster IO story)
DIGEST_SERIES = ("osd.op", "osd.op_r", "osd.op_w",
                 "osd.op_r_bytes", "osd.op_w_bytes")
#: samples per series in the digest snapshot (bounded: the digest
#: repeats every mgr_digest_interval)
DIGEST_SAMPLES = 20


def _flatten(counters: dict):
    """Yield (series_name, float) for every rate-able value in one
    MMgrReport counters payload."""
    for subsys, cs in (counters or {}).items():
        if not isinstance(cs, dict):
            continue
        for cname, v in cs.items():
            name = f"{subsys}.{cname}"
            if isinstance(v, bool):
                yield name, float(v)
            elif isinstance(v, (int, float)):
                yield name, float(v)
            elif isinstance(v, dict):
                if v.get("__labeled__"):
                    continue  # labeled rows: prometheus-path only
                if "buckets" in v:  # TYPE_HISTOGRAM dump
                    yield f"{name}.count", float(v.get("count", 0))
                    yield f"{name}.sum", float(v.get("sum", 0.0))
                elif "avgcount" in v:  # longrunavg dump
                    yield f"{name}.avgcount", float(v.get("avgcount", 0))
                    yield f"{name}.sum", float(v.get("sum", 0.0))


class MetricsHistory:
    """Bounded per-(daemon, series) sample rings + query API."""

    def __init__(self, max_samples: int = 512, max_series: int = 8192,
                 forget_age: float | None = 300.0):
        self.max_samples = max(2, int(max_samples))
        self.max_series = max(1, int(max_series))
        #: a daemon silent this long is FORGOTTEN at the next ingest —
        #: dead/renamed daemons must not pin max_series slots forever
        #: (None disables; distinct from the query-side staleness
        #: filter, which only hides, never frees)
        self.forget_age = forget_age
        self._lock = make_lock("mgr::metrics_history")
        self._series: dict[tuple[str, str], deque] = {}
        self._last_ts: dict[str, float] = {}
        # distinct (daemon, series) keys refused by the cap (bounded
        # itself) vs raw refused samples — the cardinality diagnostic
        # must count SERIES, not inflate per report
        self._refused: set[tuple[str, str]] = set()
        self._dropped_samples = 0

    # -- ingest (MgrDaemon.ms_dispatch, one call per MMgrReport) -----------
    def add_report(self, daemon: str, ts: float, counters: dict) -> None:
        with self._lock:
            if self._last_ts.get(daemon) == ts:
                # same-timestamp re-ingest (an explicit-ts caller
                # replaying a report); the mgr's dispatch path stamps
                # fresh arrival times, so there this never fires
                return
            if self.forget_age is not None:
                for gone in [d for d, t in self._last_ts.items()
                             if ts - t > self.forget_age]:
                    self._forget_daemon_locked(gone)
            self._last_ts[daemon] = ts
            for name, value in _flatten(counters):
                key = (daemon, name)
                ring = self._series.get(key)
                if ring is None:
                    if len(self._series) >= self.max_series:
                        self._dropped_samples += 1
                        if len(self._refused) < 1024:
                            self._refused.add(key)
                        continue
                    ring = self._series[key] = deque(
                        maxlen=self.max_samples)
                ring.append((ts, value))

    def _forget_daemon_locked(self, daemon: str) -> None:
        self._last_ts.pop(daemon, None)
        for key in [k for k in self._series if k[0] == daemon]:
            del self._series[key]

    def forget_daemon(self, daemon: str) -> None:
        with self._lock:
            self._forget_daemon_locked(daemon)

    # -- queries -----------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return sorted({n for _d, n in self._series})

    def daemons(self) -> list[str]:
        with self._lock:
            return sorted({d for d, _n in self._series})

    def series(self, name: str, since: float | None = None,
               daemon: str | None = None):
        """Samples of one series: ``{daemon: [(ts, value), ...]}``, or a
        plain ``[(ts, value), ...]`` when ``daemon`` is given.  ``since``
        filters to samples with ts > since (pass the last ts you saw —
        the incremental-poll idiom a controller loop uses)."""
        with self._lock:
            out = {
                d: [s for s in ring if since is None or s[0] > since]
                for (d, n), ring in self._series.items()
                if n == name and (daemon is None or d == daemon)
            }
        if daemon is not None:
            return out.get(daemon, [])
        return out

    def latest(self, name: str, daemon: str) -> tuple[float, float] | None:
        with self._lock:
            ring = self._series.get((daemon, name))
            return ring[-1] if ring else None

    def rate(self, name: str, daemon: str | None = None,
             max_age: float | None = None, now: float | None = None):
        """Per-second rate between each daemon's two most recent samples
        of a counter series — ``{daemon: rate}`` (or a float/None when
        ``daemon`` is given).  Counter resets (daemon restart) clamp to
        0 instead of a huge negative rate; a daemon whose newest sample
        is older than ``max_age`` (dead or removed) is excluded, so
        stale baselines never linger."""
        if now is None:
            import time

            now = time.monotonic()
        with self._lock:
            out: dict[str, float] = {}
            for (d, n), ring in self._series.items():
                if n != name or (daemon is not None and d != daemon):
                    continue
                if len(ring) < 2:
                    continue
                (t0, v0), (t1, v1) = ring[-2], ring[-1]
                if max_age is not None and now - t1 > max_age:
                    continue
                dt = t1 - t0
                if dt <= 0:
                    continue
                out[d] = max(0.0, (v1 - v0) / dt)
        if daemon is not None:
            return out.get(daemon)
        return out

    def rate_since(self, name: str, cursors: dict[str, float],
                   max_age: float | None = None,
                   now: float | None = None) -> dict:
        """Per-second rate between each daemon's NEWEST sample and its
        newest sample at-or-before ``cursors[daemon]`` — the
        poll-cursor idiom: a caller that samples on its own cadence
        (iostat) passes the newest ts it saw last time, so a counter
        burst BETWEEN two polls is never missed the way a
        last-two-reports rate would miss it.

        Returns ``{daemon: (rate_or_None, newest_ts)}``: rate None
        means "priming" (no cursor yet — the caller records newest_ts
        and gets a real rate next poll).  A daemon with no report newer
        than its cursor, or staler than ``max_age``, is omitted (the
        caller keeps its old cursor).  A cursor older than the ring
        tail falls back to the oldest retained sample.  Counter resets
        clamp to 0."""
        if now is None:
            import time

            now = time.monotonic()
        out: dict[str, tuple[float | None, float]] = {}
        with self._lock:
            for (d, n), ring in self._series.items():
                if n != name or not ring:
                    continue
                t1, v1 = ring[-1]
                if max_age is not None and now - t1 > max_age:
                    continue
                cur = cursors.get(d)
                if cur is None:
                    out[d] = (None, t1)  # prime
                    continue
                if t1 <= cur:
                    continue  # no new report since the caller's cursor
                base = None
                for ts, v in reversed(ring):
                    if ts <= cur:
                        base = (ts, v)
                        break
                if base is None:
                    base = ring[0]  # cursor evicted: oldest retained
                t0, v0 = base
                dt = t1 - t0
                if dt <= 0:
                    continue
                out[d] = (max(0.0, (v1 - v0) / dt), t1)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "samples": sum(len(r) for r in self._series.values()),
                "max_samples": self.max_samples,
                "max_series": self.max_series,
                "dropped_series": len(self._refused),
                "dropped_samples": self._dropped_samples,
            }

    def digest(self, names: tuple = DIGEST_SERIES,
               samples: int = DIGEST_SAMPLES) -> dict:
        """Compact snapshot for the mgr->mon digest: the `perf history`
        mon command answers from this without a mon->mgr channel."""
        with self._lock:
            daemons: dict[str, dict] = {}
            for (d, n), ring in self._series.items():
                if n not in names or not ring:
                    continue
                daemons.setdefault(d, {})[n] = [
                    [round(ts, 3), v] for ts, v in list(ring)[-samples:]
                ]
        return {"names": sorted(names), "daemons": daemons,
                "samples_per_series": samples}


@register_module
class MetricsHistoryModule(MgrModule):
    """Query surface over the MgrDaemon-owned store (the store itself
    is fed in ms_dispatch so it exists even when this module is not
    hosted — iostat reaches it through ``mgr.metrics_history``)."""

    NAME = "metrics_history"

    @property
    def store(self) -> MetricsHistory:
        return self.mgr.metrics_history

    def series(self, name: str, since: float | None = None,
               daemon: str | None = None):
        return self.store.series(name, since=since, daemon=daemon)

    def rate(self, name: str, daemon: str | None = None):
        return self.store.rate(
            name, daemon=daemon,
            max_age=self.cct.conf.get("mgr_stale_report_age"))

    def summary(self) -> dict:
        return {"stats": self.store.stats(),
                "daemons": self.store.daemons(),
                "names": self.store.names()}
