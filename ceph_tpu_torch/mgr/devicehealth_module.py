"""Devicehealth module — device failure tracking and predictive
mark-out (reference: src/pybind/mgr/devicehealth/module.py: scrape
device metrics, evaluate life expectancy, mark failing devices out
before they lose data; SURVEY.md §2.5 'other mgr modules').

The analog's health signal is the integrity-error stream the data path
already produces — scrub-detected shard inconsistencies and store-level
CRC failures (the role SMART reallocated-sector/uncorrectable counts
play for physical drives; this framework's 'devices' are stores whose
rot manifests exactly as those counters).  Per OSD the module keeps a
bounded history of (time, error-count) samples, estimates an error
RATE, and:

- `warnings()` lists OSDs whose errors grew in the sampling window
  (the DEVICE_HEALTH health-check role);
- with `mgr_devicehealth_self_heal` on, an OSD whose cumulative error
  count crosses `mgr_devicehealth_mark_out_threshold` is marked OUT via
  the mon (the mark_out_threshold behavior), letting recovery drain it
  while it can still serve reads.

The reference's dedicated `device_health_metrics` pool is elided: the
mgr keeps the bounded in-memory history and the module command surface
(`status()`) exposes it; persistence across mgr restarts would add a
pool round-trip per scrape for no test-observable behavior here.
"""
from __future__ import annotations

import time

from .module import MgrModule, register_module

_HISTORY = 128  # samples per OSD (bounded memory)


@register_module
class DeviceHealthModule(MgrModule):
    NAME = "devicehealth"

    def __init__(self, mgr):
        super().__init__(mgr)
        # daemon -> [(monotonic_ts, cumulative_errors)]
        self.history: dict[str, list[tuple[float, int]]] = {}
        self.marked_out: set[int] = set()
        self.scrapes = 0

    @staticmethod
    def _errors_of(counters: dict) -> int:
        osd = counters.get("osd", {})
        return int(osd.get("scrub_errors", 0))

    def scrape_once(self) -> None:
        now = time.monotonic()
        for daemon, counters in self.get_all_perf_counters().items():
            if not daemon.startswith("osd."):
                continue
            errs = self._errors_of(counters)
            h = self.history.setdefault(daemon, [])
            h.append((now, errs))
            del h[:-_HISTORY]
        self.scrapes += 1
        if self.cct.conf.get("mgr_devicehealth_self_heal"):
            self._self_heal()

    def warnings(self) -> dict[str, dict]:
        """OSDs whose error count GREW within the retained window
        (reference: the DEVICE_HEALTH_* health checks)."""
        out = {}
        for daemon, h in self.history.items():
            if len(h) < 2:
                continue
            grew = h[-1][1] - h[0][1]
            if grew > 0:
                dt = max(h[-1][0] - h[0][0], 1e-9)
                out[daemon] = {
                    "errors": h[-1][1],
                    "new_errors": grew,
                    "rate_per_hour": round(grew / dt * 3600.0, 3),
                }
        return out

    def _self_heal(self) -> None:
        threshold = self.cct.conf.get("mgr_devicehealth_mark_out_threshold")
        min_ratio = self.cct.conf.get("mgr_devicehealth_min_in_ratio")
        m = self.get("osd_map")
        if m is None:
            return
        # marked_out only exists to bridge map-propagation delay: once the
        # map confirms an OSD is out, drop the entry — keeping it would
        # permanently undercount n_in and permanently exempt the OSD from
        # self-heal after an operator replaces the device and marks it
        # back in
        self.marked_out = {o for o in self.marked_out if m.is_in(o)}
        # the in-count is tracked LOCALLY across this pass (and debited
        # for mark-outs we already issued whose map hasn't propagated):
        # checking each candidate against the same stale map would let a
        # storm that pushes several OSDs over the threshold at once mark
        # them all out and sail through the floor one stale read at a time
        existing = [o for o in range(m.max_osd) if m.exists(o)]
        n_in = sum(
            1 for o in existing
            if m.is_in(o) and o not in self.marked_out
        )
        for daemon, h in self.history.items():
            if not h or h[-1][1] < threshold:
                continue
            osd = int(daemon.split(".", 1)[1])
            if osd in self.marked_out or not m.is_in(osd):
                continue
            # never self-heal the cluster into an outage: refuse once
            # the in-ratio would drop below the floor (reference:
            # devicehealth's mon_osd_min_in_ratio guard — a cluster-wide
            # error storm must not mark everything out)
            if existing and (n_in - 1) / len(existing) < min_ratio:
                self.cct.dout(
                    "mgr", 0,
                    f"devicehealth: NOT marking osd.{osd} out — in-ratio "
                    f"would drop below {min_ratio}",
                )
                continue
            rv, res = self.mon_command({"prefix": "osd out", "id": osd})
            if rv == 0:
                self.marked_out.add(osd)
                n_in -= 1
                self.cct.dout(
                    "mgr", 0,
                    f"devicehealth: marked osd.{osd} OUT "
                    f"({h[-1][1]} integrity errors >= {threshold})",
                )

    def status(self) -> dict:
        return {
            "scrapes": self.scrapes,
            "tracked": sorted(self.history),
            "warnings": self.warnings(),
            "marked_out": sorted(self.marked_out),
        }

    def serve(self) -> None:
        interval = self.cct.conf.get("mgr_tick_interval")
        while not self._stop.wait(interval):
            try:
                self.scrape_once()
            except Exception as e:  # pragma: no cover - defensive loop
                self.cct.dout("mgr", 1, f"devicehealth scrape failed: {e!r}")
