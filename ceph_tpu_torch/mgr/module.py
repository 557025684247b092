"""MgrModule — the module-host contract (reference: src/mgr/ActivePyModule
+ src/pybind/mgr/mgr_module.py :: MgrModule; SURVEY.md §2.5).

A module runs `serve()` on its own thread until `shutdown()`; the host
hands it cluster state (maps, daemon perf reports) and a mon-command
channel, mirroring the reference's MgrModule API surface the in-tree
modules actually use (get, get_all_perf_counters, mon_command,
set_module_option-ish config reads)."""
from __future__ import annotations

import threading


class MgrModule:
    NAME = "module"

    def __init__(self, mgr):
        self.mgr = mgr
        self.cct = mgr.cct
        self._stop = threading.Event()

    # -- host-provided state ------------------------------------------------
    def get(self, what: str):
        """reference: MgrModule.get — 'osd_map' is the one every in-tree
        module starts from."""
        if what == "osd_map":
            return self.mgr.mc.osdmap
        if what == "mon_status":
            rv, res = self.mgr.mc.command({"prefix": "mon stat"})
            return res if rv == 0 else None
        raise KeyError(what)

    def get_all_perf_counters(self) -> dict:
        """{daemon: {subsystem: {counter: value}}} from the freshest
        MMgrReport of each daemon (reference: get_all_perf_counters)."""
        return self.mgr.latest_reports()

    def get_perf_schema(self) -> dict:
        """{subsystem: {counter: {type, description}}} merged across
        daemons (reference: MMgrReport's PerfCounterType declarations)."""
        return self.mgr.latest_schemas()

    def mon_command(self, cmd: dict):
        return self.mgr.mc.command(cmd)

    # -- lifecycle ----------------------------------------------------------
    def serve(self) -> None:  # pragma: no cover - abstract loop
        self._stop.wait()

    def shutdown(self) -> None:
        self._stop.set()


MODULE_REGISTRY: dict[str, type] = {}


def register_module(cls: type) -> type:
    MODULE_REGISTRY[cls.NAME] = cls
    return cls
