"""MgrDaemon — module host + daemon report sink (reference: src/mgr/Mgr.cc
/ DaemonServer.cc: daemons stream MMgrReport, modules consume the state;
SURVEY.md §2.5).

    mgr = MgrDaemon(cct, mon_addrs)
    mgr.start()                  # hosts cct.conf 'mgr_modules'
    mgr.module('prometheus').url # scrape target

The port's counterpart of ceph_tpu/mgr/daemon.py.  The mgr runs on its
context's device (``cuda`` unless the cluster was built with
``device="cpu"``): the maps its MonClient decodes carry it, so the
placement scan's and the balancer's ``map_pool`` launch K3 there.
"""
from __future__ import annotations

import threading
import time

from ..common.device import resolve_device
from ..mon.mon_client import MonClient
from ..msg import Dispatcher, Messenger
from .messages import MMgrReport
from .module import MODULE_REGISTRY, MgrModule

# imports register the in-tree modules
from . import balancer_module  # noqa: F401
from . import dashboard_module  # noqa: F401
from . import devicehealth_module  # noqa: F401
from . import iostat_module  # noqa: F401
from . import quota_module  # noqa: F401
from . import pg_autoscaler_module  # noqa: F401
from . import placement_module  # noqa: F401
from . import progress_module  # noqa: F401
from . import prometheus_module  # noqa: F401
from . import qos_module  # noqa: F401
from . import status_module  # noqa: F401
from .metrics_history import MetricsHistory  # also registers the module


class MgrDaemon(Dispatcher):
    def __init__(self, cct, mon_addrs):
        self.cct = cct
        #: where the modules' batched placement runs: the context's device
        self.device = resolve_device(cct.device)
        self.messenger = Messenger.create(cct, "mgr")
        self.messenger.add_dispatcher(self)
        self.mc = MonClient(cct, mon_addrs, name="mgr-monc")
        self.messenger.auth_gen_provider = lambda: (
            self.mc.osdmap.auth_gens.get("mgr", 1) if self.mc.osdmap else 1
        )
        self._reports: dict[str, dict] = {}   # daemon -> last MMgrReport view
        self._reports_lock = threading.Lock()
        # cephqos: the connection each daemon's last report arrived on —
        # the controller's push channel back to it (MQoSSettings rides
        # the report plumbing instead of dialing admin sockets)
        self._report_conns: dict[str, object] = {}
        # cephmeter: the bounded time-series ring every history consumer
        # (iostat, `perf history`, future QoS controllers) queries — fed
        # synchronously per incoming MMgrReport, daemon-owned so it
        # exists whether or not the metrics_history module is hosted
        self.metrics_history = MetricsHistory(
            max_samples=int(cct.conf.get("mgr_metrics_history_samples")),
            max_series=int(cct.conf.get("mgr_metrics_history_max_series")),
            # well past the query-side staleness filter: hidden first,
            # forgotten (series slots freed) only once clearly dead
            forget_age=10 * float(cct.conf.get("mgr_stale_report_age")),
        )
        self._modules: dict[str, MgrModule] = {}
        #: {module: repr of what ended its serve loop} — a module whose
        #: kernel did not build or launch stops here instead of going on
        self.failed_modules: dict[str, str] = {}
        self._threads: list[threading.Thread] = []
        self.addr: tuple[str, int] | None = None
        self._mon_addrs = mon_addrs
        self._rados = None  # lazy module-facing RADOS client
        self._rados_lock = threading.Lock()
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.addr = self.messenger.bind(("127.0.0.1", 0))
        self.messenger.start()
        self.mc.subscribe_osdmap()
        self.mc.wait_for_osdmap(timeout=30.0)
        wanted = [
            m.strip()
            for m in str(self.cct.conf.get("mgr_modules")).split(",")
            if m.strip()
        ]
        for name in wanted:
            cls = MODULE_REGISTRY.get(name)
            if cls is None:
                self.cct.dout("mgr", 0, f"mgr: unknown module {name!r}")
                continue
            try:
                mod = cls(self)
            except Exception as e:
                # one module failing to construct (e.g. prometheus port
                # taken) must not take down the whole mgr
                self.cct.dout(
                    "mgr", 0, f"mgr module {name!r} failed to load: {e!r}"
                )
                continue
            self._modules[name] = mod
            t = threading.Thread(
                target=self._serve_module, args=(mod,),
                name=f"mgr-{name}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _serve_module(self, mod: MgrModule) -> None:
        try:
            mod.serve()
        except Exception as e:
            self.failed_modules[mod.NAME] = repr(e)
            self.cct.dout("mgr", 0, f"mgr module {mod.NAME} died: {e!r}")

    def shutdown(self) -> None:
        with self._rados_lock:
            self._closed = True  # no module may lazily mint a client now
        for mod in self._modules.values():
            try:
                mod.shutdown()
            except Exception as e:
                self.cct.dout("mgr", 0,
                              f"mgr module {mod.NAME} shutdown raised: {e!r}")
        # rados AFTER the modules that reach through it
        with self._rados_lock:
            if self._rados is not None:
                try:
                    self._rados.shutdown()
                except Exception as e:
                    self.cct.dout("mgr", 0,
                                  f"mgr rados shutdown raised: {e!r}")
                self._rados = None
        # module serve threads before the transports they report
        # through (teardown reverses bring-up)
        for t in self._threads:
            t.join(timeout=5)
        try:
            self.mc.shutdown()
        except Exception as e:
            self.cct.dout("mgr", 0,
                          f"mgr mon client shutdown raised: {e!r}")
        try:
            self.messenger.shutdown()
        except Exception as e:
            self.cct.dout("mgr", 0,
                          f"mgr messenger shutdown raised: {e!r}")
        # the context goes last: its admin socket serves debug commands
        # right up until the daemon is gone
        self.cct.shutdown()

    def module(self, name: str) -> MgrModule:
        return self._modules[name]

    # -- report sink -------------------------------------------------------
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMgrReport):
            ts = time.monotonic()
            with self._reports_lock:
                self._reports[msg.daemon] = {
                    "counters": msg.counters or {},
                    "schema": getattr(msg, "schema", None) or {},
                    "stats": msg.stats or {},
                    "epoch": msg.epoch,
                    "ts": ts,
                }
                self._report_conns[msg.daemon] = conn
            # one history sample per report, stamped with the ARRIVAL
            # time (rates divide by the report interval, not a sampling
            # cadence) — outside the reports lock; the store has its own
            self.metrics_history.add_report(
                msg.daemon, ts, msg.counters or {})
            return True
        return False

    def report_conns(self, prefix: str = "") -> dict:
        """{daemon: connection} of the freshest report senders (optionally
        filtered by name prefix, e.g. "osd.") — the QoS controller's
        push fan-out.  Staleness mirrors latest_reports: a dead daemon's
        conn must not be dialed forever."""
        max_age = self.cct.conf.get("mgr_stale_report_age")
        now = time.monotonic()
        with self._reports_lock:
            return {
                d: c for d, c in self._report_conns.items()
                if d.startswith(prefix)
                and d in self._reports
                and now - self._reports[d]["ts"] <= max_age
            }

    def ingest_local_report(self, daemon: str, counters: dict,
                            schema: dict | None = None,
                            stats: dict | None = None) -> None:
        """Feed a report authored INSIDE the mgr process (the QoS
        module's ceph_qos_* series) through the same sink daemon
        reports take: it lands in the latest-reports view (so the
        prometheus exporter renders it) AND the metrics-history ring
        (so the controller's own decisions are queryable history)."""
        ts = time.monotonic()
        with self._reports_lock:
            self._reports[daemon] = {
                "counters": counters or {},
                "schema": schema or {},
                "stats": stats or {},
                "epoch": 0,
                "ts": ts,
            }
        self.metrics_history.add_report(daemon, ts, counters or {})

    def latest_reports(self) -> dict:
        """{daemon: {subsystem: {counter: value}}}, stale reports dropped
        (a dead OSD's last snapshot must not linger on the dashboard)."""
        max_age = self.cct.conf.get("mgr_stale_report_age")
        now = time.monotonic()
        with self._reports_lock:
            return {
                d: r["counters"]
                for d, r in self._reports.items()
                if now - r["ts"] <= max_age
            }

    def latest_schemas(self) -> dict:
        """Merged {subsystem: {counter: {type, description}}} across
        daemons (same subsystem name = same declaration; later daemons
        win harmlessly) — the prometheus exporter's HELP/TYPE source."""
        merged: dict = {}
        with self._reports_lock:
            reports = [r.get("schema") or {} for r in self._reports.values()]
        for schema in reports:
            for subsys, counters in schema.items():
                merged.setdefault(subsys, {}).update(counters or {})
        return merged

    def rados_ioctx(self, pool: str):
        """Pool I/O handle for modules (the reference mgr holds its own
        librados instance modules reach through MgrModule.rados).
        Serialized + fail-safe: module HTTP threads race here, a failed
        connect must not leak its half-started client, and nothing may
        lazily mint a client after shutdown."""
        with self._rados_lock:
            if self._closed:
                raise IOError("mgr shutting down")
            if self._rados is None:
                from ..client.rados import Rados

                r = Rados(self.cct, self._mon_addrs, name="mgr-rados")
                try:
                    r.connect(timeout=10.0)
                except Exception:
                    r.shutdown()
                    raise
                self._rados = r
            return self._rados.open_ioctx(pool)

    def latest_reports_with_ts(self) -> dict:
        """{daemon: (arrival_ts, counters)} — rate computations must
        divide by the REPORT interval, not the caller's sampling
        interval (iostat)."""
        max_age = self.cct.conf.get("mgr_stale_report_age")
        now = time.monotonic()
        with self._reports_lock:
            return {
                d: (r["ts"], r["counters"])
                for d, r in self._reports.items()
                if now - r["ts"] <= max_age
            }

    def latest_stats(self) -> dict:
        return {d: s for d, (_t, s)
                in self.latest_stats_with_ts().items()}

    def pg_degraded_by_pgid(self) -> dict[str, int]:
        """Freshest-wins union of the primaries' pg_info rows ->
        {pgid: degraded objects}.  THE shared merge (progress module,
        balancer degraded-gate): each PG has one live author, but a
        deposed primary's final report lingers up to
        mgr_stale_report_age — merged oldest-first so the freshest
        author wins a same-pgid collision."""
        out: dict[str, int] = {}
        for _ts, st in sorted(self.latest_stats_with_ts().values(),
                              key=lambda tv: tv[0]):
            for pgid, info in (st.get("pg_info") or {}).items():
                out[pgid] = int(info.get("degraded") or 0)
        return out

    def latest_stats_with_ts(self) -> dict:
        """{daemon: (arrival_ts, stats)} — consumers that merge
        per-PG rows across daemons (progress, the status digest) must
        arbitrate duplicates by report FRESHNESS: after a primary
        change, the dead primary's final report lingers up to
        mgr_stale_report_age and its stale pg_info rows must not mask
        the new primary's (cephheal)."""
        max_age = self.cct.conf.get("mgr_stale_report_age")
        now = time.monotonic()
        with self._reports_lock:
            return {
                d: (r["ts"], r["stats"])
                for d, r in self._reports.items()
                if now - r["ts"] <= max_age
            }
