"""CephContext — one process-entity's runtime state (reference:
src/common/ceph_context.{h,cc} :: CephContext; created by global_init in
src/global/global_init.cc, SURVEY.md §3.4).

Bundles the layered config, log, perf-counter collection, heartbeat map and
(optional) admin socket that every daemon and client library hangs off.
Contexts are explicit — no process-global — so tests can run many entities
(mon + N osds + clients) in one interpreter, which is how the ring-2
single-host cluster tests work (SURVEY.md §4).
"""
from __future__ import annotations

import os
from .admin_socket import AdminSocket
from .config import Config, LEVEL_CMDLINE
from .heartbeat import HeartbeatMap
from .log import Log
from .options import default_options
from .perf_counters import PerfCountersCollection


class CephContext:
    def __init__(self, name: str = "client.admin", overrides: dict | None = None):
        self.conf = Config(default_options())
        self.conf.set("name", name, level=LEVEL_CMDLINE)
        if overrides:
            for k, v in overrides.items():
                self.conf.set(k, v, level=LEVEL_CMDLINE)
        self.log = Log(self.conf, ring_size=self.conf.get("log_ring_size"))
        if self.conf.get("lockdep"):
            from . import lockdep

            lockdep.enable()
        self.perf = PerfCountersCollection()
        self.heartbeat_map = HeartbeatMap()
        if self.conf.get("trace_enabled"):
            # the tracer is process-wide (spans carry the entity label,
            # so a LocalCluster's daemons stay attributable); any armed
            # context switches it on for the process
            from .tracer import TRACER

            TRACER.enable(True)
        if not self.conf.get("kernel_telemetry"):
            # the kernel telemetry registry is process-wide like the
            # tracer, but default-ON (observability parity with perf
            # counters); a context disabling it disarms the process —
            # disabled dispatch pays one attribute check (PERF.md)
            from .kernel_telemetry import TELEMETRY

            TELEMETRY.enable(False)
        # mon-minted service tickets for cephx clients without the cluster
        # secret: {service: {"ticket": blob_hex, "session_key": hex}};
        # runtime credentials, not config (reference: the client-side
        # CephXTicketManager)
        self.tickets: dict[str, dict] = {}
        # fault injection: route this context's inject options (legacy +
        # the generic `failpoint` option) through the process-wide
        # failpoint registry, scoped to hits tagged with this context
        from . import failpoint as _failpoint

        _failpoint.bind_config(self)
        self.admin_socket: AdminSocket | None = None
        sock_path = self.conf.get_expanded("admin_socket")
        if sock_path:
            self.admin_socket = AdminSocket(sock_path)
            self._register_default_commands()
            _failpoint.register_admin_commands(self)
            self.admin_socket.start()

    @property
    def name(self) -> str:
        return self.conf.get("name")

    def dout(self, subsys: str, level: int, message: str) -> None:
        self.log.dout(subsys, level, message)

    def _register_default_commands(self) -> None:
        ask = self.admin_socket
        assert ask is not None
        ask.register_command(
            "perf dump", lambda c: self.perf.dump(), "dump perf counters"
        )
        ask.register_command(
            "perf schema", lambda c: self.perf.schema(), "perf counter schema"
        )
        ask.register_command(
            "config show", lambda c: self.conf.show_config(), "show config"
        )
        ask.register_command(
            "config diff", lambda c: self.conf.diff(), "non-default config"
        )
        ask.register_command(
            "config get",
            lambda c: {c["var"]: self.conf.get(c["var"])},
            "config get var=<name>",
        )
        ask.register_command(
            "config set", self._config_set_cmd,
            "config set var=<name> val=<value> (runtime-updatable options only)",
        )
        ask.register_command(
            "log dump", lambda c: [e.format() for e in self.log.recent(100)],
            "recent log ring entries",
        )
        ask.register_command(
            "dump_tracing", self._dump_tracing_cmd,
            "cephtrace spans/events for this daemon "
            "(all=true for the whole process; format=perfetto for "
            "Chrome-trace JSON loadable in ui.perfetto.dev)",
        )
        ask.register_command(
            "dump_kernel_telemetry", self._dump_kernel_telemetry_cmd,
            "per-kernel dispatch telemetry + backend sentinel state "
            "(process-wide; docs/observability.md)",
        )

    def _dump_kernel_telemetry_cmd(self, cmd: dict) -> object:
        from .kernel_telemetry import dump_kernel_telemetry

        return dump_kernel_telemetry()

    def _dump_tracing_cmd(self, cmd: dict) -> object:
        from .tracer import dump_tracing

        entity = None if cmd.get("all") else self.name
        return dump_tracing(entity=entity,
                            fmt=str(cmd.get("format", "spans")))

    def _config_set_cmd(self, cmd: dict) -> dict:
        # live `config set` honors the option's runtime flag (reference:
        # non-runtime options need a daemon restart; mon `config set` warns)
        name = cmd["var"]
        if not self.conf.table.get(name).runtime:
            raise ValueError(
                f"option {name!r} is not runtime-updatable; restart required"
            )
        return {name: self.conf.set(name, cmd["val"])}

    def shutdown(self) -> None:
        from . import failpoint as _failpoint

        _failpoint.unbind(self)
        if self.admin_socket is not None:
            self.admin_socket.stop()
            self.admin_socket = None
