"""Dashboard module — HTTP cluster dashboard (reference:
src/pybind/mgr/dashboard — here the REST layer + a server-rendered
status page rather than the Angular SPA, which is presentation the
framework's API surface does not depend on; SURVEY.md §2.5).

Endpoints (JSON unless noted):

    /                     HTML cluster summary (health, OSDs, pools)
    /api/health           `ceph -s` style health + check details
    /api/osd              per-OSD up/in/pgs/objects rows
    /api/pool             per-pool type/size/pg_num/bytes
    /api/perf             latest per-daemon perf counter snapshots
    /api/iostat           cluster + per-daemon IO rates (iostat module)
    /api/fs               MDS ranks, beacon liveness, subtree pins
    /api/df               cluster + per-pool usage (same as `ceph df`)

Read-only by design: mutations belong to the `ceph` CLI / mon command
surface (the reference dashboard's write paths wrap the same mon
commands and carry no extra semantics).
"""
from __future__ import annotations

import html
import http.server
import json
import threading

from .module import MgrModule, register_module


def _esc(s) -> str:
    return html.escape(str(s))


@register_module
class DashboardModule(MgrModule):
    NAME = "dashboard"

    def __init__(self, mgr):
        super().__init__(mgr)
        port = int(self.cct.conf.get("mgr_dashboard_port"))
        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), self._handler_class()
        )
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/"

    # -- data assembly -----------------------------------------------------
    def health(self) -> dict:
        rv, res = self.mon_command({"prefix": "status"})
        return res if rv == 0 else {"error": res}

    def osd_rows(self) -> list[dict]:
        # one assembly shared with `ceph osd status` (status module) so
        # the two surfaces can never drift apart
        from .status_module import assemble_osd_rows

        return assemble_osd_rows(self.get("osd_map"),
                                 self.mgr.latest_stats())

    def pool_rows(self) -> list[dict]:
        m = self.get("osd_map")
        stats = self.mgr.latest_stats()
        rows = []
        if m is None:
            return rows
        for pid, p in sorted(m.pools.items()):
            nbytes = 0
            for st in stats.values():
                nbytes += int(st.get("pool_bytes", {}).get(str(pid), 0))
            rows.append({
                "id": pid, "name": p.name,
                "type": "erasure" if p.ec_profile else "replicated",
                "size": p.size, "pg_num": p.pg_num, "bytes": nbytes,
            })
        return rows

    def iostat(self) -> dict:
        mod = self.mgr._modules.get("iostat")
        if mod is None:
            return {"error": "iostat module not hosted"}
        return mod.sample()

    def fs_ranks(self) -> list[dict]:
        """MDS rank table (the `ceph fs status` data, JSON); the
        reference assembles it in fs/mds.py, which is not ported."""
        raise NotImplementedError(
            "fs_ranks: CephFS is not ported yet (ROADMAP queue 1 item 8)")

    def _page(self) -> str:
        h = self.health()
        # the mon nests: {"health": {"status": ..., "checks": {...}}, ...}
        hblock = h.get("health") if isinstance(h.get("health"), dict) else {}
        status = hblock.get("status", h.get("error", "?"))
        checks = hblock.get("checks", {})
        osds = self.osd_rows()
        pools = self.pool_rows()
        osd_rows = "".join(
            f"<tr><td>osd.{r['id']}</td><td>{'up' if r['up'] else 'down'}"
            f"</td><td>{'in' if r['in'] else 'out'}</td>"
            f"<td>{r['pgs']}</td><td>{r['objects']}</td></tr>"
            for r in osds
        )
        pool_rows = "".join(
            f"<tr><td>{r['id']}</td><td>{_esc(r['name'])}</td>"
            f"<td>{r['type']}</td><td>{r['size']}</td>"
            f"<td>{r['pg_num']}</td><td>{r['bytes']}</td></tr>"
            for r in pools
        )
        return (
            "<!doctype html><html><head><title>ceph_tpu dashboard</title>"
            "<style>body{font-family:monospace;margin:2em}"
            "table{border-collapse:collapse;margin:1em 0}"
            "td,th{border:1px solid #999;padding:2px 8px}</style></head>"
            f"<body><h1>cluster: {_esc(status)}</h1>"
            f"<pre>{_esc(json.dumps(checks, indent=1))}</pre>"
            "<h2>OSDs</h2><table><tr><th>osd</th><th>state</th>"
            f"<th>in/out</th><th>pgs</th><th>objects</th></tr>{osd_rows}"
            "</table><h2>Pools</h2><table><tr><th>id</th><th>name</th>"
            "<th>type</th><th>size</th><th>pg_num</th><th>bytes</th></tr>"
            f"{pool_rows}</table></body></html>"
        )

    def df(self) -> dict:
        """Cluster/pool usage — same assembly the mon's `ceph df` serves
        (status_module.assemble_df), so the two can never drift."""
        from .status_module import assemble_df

        return assemble_df(self.get("osd_map"), self.mgr.latest_stats())

    # -- http ---------------------------------------------------------------
    def _handler_class(self):
        module = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                try:
                    if path == "":
                        body = module._page().encode()
                        ctype = "text/html"
                    elif path == "/api/health":
                        body = json.dumps(module.health()).encode()
                        ctype = "application/json"
                    elif path == "/api/osd":
                        body = json.dumps(module.osd_rows()).encode()
                        ctype = "application/json"
                    elif path == "/api/pool":
                        body = json.dumps(module.pool_rows()).encode()
                        ctype = "application/json"
                    elif path == "/api/perf":
                        body = json.dumps(
                            module.get_all_perf_counters()).encode()
                        ctype = "application/json"
                    elif path == "/api/iostat":
                        body = json.dumps(module.iostat()).encode()
                        ctype = "application/json"
                    elif path == "/api/fs":
                        body = json.dumps(module.fs_ranks()).encode()
                        ctype = "application/json"
                    elif path == "/api/df":
                        body = json.dumps(module.df()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # a bad scrape must not kill http
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        return Handler

    def serve(self) -> None:
        t = threading.Thread(
            target=self._server.serve_forever, name="mgr-dashboard-http",
            daemon=True,
        )
        t.start()
        self._stop.wait()
        self._server.shutdown()
        self._server.server_close()
        t.join(timeout=5)  # serve_forever returned at shutdown()
