"""Prometheus exporter module (reference: src/pybind/mgr/prometheus/
module.py — text exposition of cluster health + daemon perf counters).

Serves GET /metrics on `mgr_prometheus_port` (0 = ephemeral; read
`.url` after start).  Metric naming follows the reference's scheme:
`ceph_osd_up`-style cluster gauges plus `ceph_daemon_...` counter series
labelled by daemon."""
from __future__ import annotations

import http.server
import threading

from ..common.perf_counters import HIST_LE
from .module import MgrModule, register_module

#: exposition-time cardinality guard for labeled (per-client) series:
#: at most this many label sets per daemon per labeled structure; the
#: overflow folds into one `_other_` row (sums preserved) — the second
#: bound after the OSD table's own top-K (docs/observability.md)
_MAX_LABEL_SETS = 256


def _sanitize_label(v) -> str:
    """Label-value hygiene for client entity names: control characters
    (incl. newline before esc() would see it) are stripped and the
    value is length-capped, so one hostile or mangled entity name
    cannot poison the exposition or explode a label.  Quotes and
    backslashes are handled by esc() at emission."""
    s = str(v)
    if any(ch < " " or ch == "\x7f" for ch in s):
        s = "".join(ch for ch in s if ch >= " " and ch != "\x7f")
    return s[:120] if len(s) > 120 else s


def _fold_labeled_rows(rows: list, cap: int = _MAX_LABEL_SETS) -> list:
    """Cap a labeled-row list, folding the tail (plus any pre-existing
    `_other_` rows) into ONE `_other_` row whose scalar fields sum and
    whose histograms merge bucket-by-bucket — counts survive the cap,
    only attribution is lost."""
    if len(rows) <= cap:
        return rows
    keep = [r for r in rows[:cap - 1]
            if (r.get("labels") or {}).get("client") != "_other_"]
    fold = [r for r in rows if r not in keep]
    merged: dict = {"labels": {
        k: "_other_" for k in (fold[0].get("labels") or {"client": 0})
    }}
    for row in fold:
        for f, v in row.items():
            if f == "labels":
                continue
            if isinstance(v, dict) and "buckets" in v:
                agg = merged.setdefault(f, {
                    "count": 0, "sum": 0.0,
                    "buckets": [0] * len(v["buckets"]),
                })
                agg["count"] += v.get("count", 0)
                agg["sum"] += v.get("sum", 0.0)
                for i, c in enumerate(v["buckets"]):
                    agg["buckets"][i] += c
            elif isinstance(v, (int, float)):
                merged[f] = merged.get(f, 0) + v
    return keep + [merged]


def render_metrics(osdmap, reports: dict, schema: dict | None = None,
                   health: dict | None = None) -> str:
    """Text exposition (the pure part, unit-testable without sockets).

    `schema` is the merged {subsystem: {counter: {type, description}}}
    the daemons ship inside MMgrReport: HELP text comes from each
    counter's declared `doc` and TYPE from its PerfCounters type —
    u64/time -> counter, gauge -> gauge, histogram -> a real prometheus
    histogram with cumulative log2 `le` buckets (+Inf, _sum, _count).
    Counters without schema fall back to the generic rendering, so a
    daemon predating the schema field still exports.

    `health` is the mon's `health` payload: rendered as
    `ceph_health_status` (0=OK 1=WARN 2=ERR) plus one
    `ceph_health_detail{name,severity}` series per ACTIVE check —
    upstream mgr/prometheus parity, which is what makes the new
    TPU_BACKEND_DEGRADED / KERNEL_FALLBACK_LATCHED checks scrapeable."""
    lines: list[str] = []
    schema = schema or {}

    def esc(v) -> str:
        # exposition-format label escaping: one bad pool name must not
        # poison the whole scrape
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    def metric(name, doc, typ, samples):
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} {typ}")
        for labels, value in samples:
            lab = (
                "{" + ",".join(f'{k}="{esc(v)}"' for k, v in labels.items()) + "}"
                if labels
                else ""
            )
            lines.append(f"{name}{lab} {value}")

    if health is not None:
        hblock = health.get("health") if isinstance(
            health.get("health"), dict) else {}
        status = (hblock or {}).get("status")
        metric(
            "ceph_health_status",
            "cluster health status (0=HEALTH_OK 1=HEALTH_WARN "
            "2=HEALTH_ERR; reference: mgr/prometheus health_status)",
            "gauge",
            [({}, {"HEALTH_OK": 0, "HEALTH_WARN": 1,
                   "HEALTH_ERR": 2}.get(status, 2))],
        )
        checks = (hblock or {}).get("checks") or {}
        if checks:
            metric(
                "ceph_health_detail",
                "active health checks (1 per check; reference: "
                "mgr/prometheus health_detail)", "gauge",
                [
                    ({"name": name,
                      "severity": chk.get("severity", "HEALTH_WARN")}, 1)
                    for name, chk in sorted(checks.items())
                ],
            )
    if osdmap is not None:
        metric(
            "ceph_osd_up", "OSD up state", "gauge",
            [
                ({"ceph_daemon": f"osd.{o}"}, int(osdmap.is_up(o)))
                for o in range(osdmap.max_osd)
                if osdmap.exists(o)
            ],
        )
        metric(
            "ceph_osd_in", "OSD in state", "gauge",
            [
                ({"ceph_daemon": f"osd.{o}"}, int(osdmap.is_in(o)))
                for o in range(osdmap.max_osd)
                if osdmap.exists(o)
            ],
        )
        metric(
            "ceph_osdmap_epoch", "OSDMap epoch", "gauge",
            [({}, osdmap.epoch)],
        )
        metric(
            "ceph_pool_pg_num", "PGs per pool", "gauge",
            [
                ({"pool": p.name}, p.pg_num)
                for p in osdmap.pools.values()
            ],
        )
    # per-daemon perf counters: flatten subsystem dumps into one series
    # per counter, labelled by daemon (the reference's ceph_daemon label)
    series: dict[str, list] = {}
    hists: dict[str, dict] = {}   # base -> {"doc", "bucket", "sum", "count"}
    meta: dict[str, tuple[str, str]] = {}  # key -> (help, type)

    def declared(subsys: str, cname: str, key: str,
                 default_typ: str) -> tuple[str, str]:
        sch = (schema.get(subsys) or {}).get(cname) or {}
        doc = sch.get("description") or f"perf counter {key}"
        typ = "gauge" if sch.get("type") == "gauge" else default_typ
        return doc, typ

    def add_hist(key: str, doc: str, labels: dict, value: dict) -> None:
        """Accumulate one histogram dump (cumulative le buckets)."""
        h = hists.setdefault(key, {
            "doc": doc, "bucket": [], "sum": [], "count": [],
        })
        cum = 0
        for i, c in enumerate(value["buckets"]):
            cum += c
            le = f"{HIST_LE[i]:.6g}" if i < len(HIST_LE) else "+Inf"
            h["bucket"].append(({**labels, "le": le}, cum))
        h["sum"].append((labels, value["sum"]))
        h["count"].append((labels, value["count"]))

    for daemon, subsystems in sorted(reports.items()):
        labels = {"ceph_daemon": daemon}
        for subsys, counters in sorted((subsystems or {}).items()):
            for cname, value in sorted(counters.items()):
                key = f"ceph_{subsys}_{cname}"
                if isinstance(value, dict) and value.get("__labeled__"):
                    # cephmeter labeled rows (the per-(client,pool)
                    # accounting table): each row's fields become
                    # ceph_<subsys>_<field>{ceph_daemon,client,pool,...}
                    # series; sanitized label values, bounded row count
                    for row in _fold_labeled_rows(value.get("rows") or []):
                        rl = {**labels, **{
                            k: _sanitize_label(v)
                            for k, v in (row.get("labels") or {}).items()
                        }}
                        for f, v in sorted(row.items()):
                            if f == "labels":
                                continue
                            fkey = f"ceph_{subsys}_{f}"
                            if isinstance(v, dict) and "buckets" in v:
                                add_hist(
                                    fkey,
                                    declared(subsys, f, fkey,
                                             "histogram")[0],
                                    rl, v)
                            elif isinstance(v, (int, float)):
                                meta.setdefault(fkey, declared(
                                    subsys, f, fkey, "counter"))
                                series.setdefault(fkey, []).append(
                                    (rl, v))
                    continue
                if isinstance(value, dict) and "buckets" in value:
                    # log2-bucket latency histogram (PerfCounters
                    # TYPE_HISTOGRAM): cumulative le buckets, seconds
                    add_hist(key, declared(subsys, cname, key,
                                           "histogram")[0], labels, value)
                elif isinstance(value, dict):  # longrunavg {avgcount, sum}
                    for part, v in value.items():
                        pkey = f"{key}_{part}"
                        meta.setdefault(
                            pkey, declared(subsys, cname, pkey, "counter"))
                        series.setdefault(pkey, []).append((labels, v))
                else:
                    meta.setdefault(
                        key, declared(subsys, cname, key, "counter"))
                    series.setdefault(key, []).append((labels, value))
    for key, samples in sorted(series.items()):
        doc, typ = meta.get(key, (f"perf counter {key}", "counter"))
        metric(key, doc, typ, samples)
    for base, h in sorted(hists.items()):
        lines.append(f"# HELP {base} {h['doc']}")
        lines.append(f"# TYPE {base} histogram")
        for suffix in ("bucket", "sum", "count"):
            for labels, value in h[suffix]:
                lab = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
                lines.append(f"{base}_{suffix}{{{lab}}} {value}")
    return "\n".join(lines) + "\n"


@register_module
class PrometheusModule(MgrModule):
    NAME = "prometheus"

    def __init__(self, mgr):
        super().__init__(mgr)
        # bind SYNCHRONOUSLY (module construction happens inside
        # MgrDaemon.start) so `mgr.start(); module('prometheus').url`
        # never races the serve thread
        port = int(self.cct.conf.get("mgr_prometheus_port"))
        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), self._handler_class()
        )
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/metrics"

    def _handler_class(self):
        module = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    # cluster health piggybacks the scrape (a mon round
                    # trip); an unreachable/electing mon drops the
                    # health series, never the whole exposition
                    try:
                        rv, health = module.mon_command(
                            {"prefix": "health"})
                        if rv != 0 or not isinstance(health, dict):
                            health = None
                    except Exception:
                        health = None
                    body = render_metrics(
                        module.get("osd_map"),
                        module.get_all_perf_counters(),
                        schema=module.get_perf_schema(),
                        health=health,
                    ).encode()
                except Exception as e:  # scrape must not kill the server
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        return Handler

    def serve(self) -> None:
        t = threading.Thread(
            target=self._server.serve_forever, name="mgr-prometheus-http",
            daemon=True,
        )
        t.start()
        self._stop.wait()
        self._server.shutdown()
        self._server.server_close()
        t.join(timeout=5)  # serve_forever returned at shutdown()
