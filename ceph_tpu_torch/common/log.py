"""Subsystem logging with an always-on in-memory ring (reference:
src/common/dout.h, src/log/Log.cc, subsystem table src/common/subsys.h;
SURVEY.md §5.5).

Every entry is recorded in the ring regardless of level (the reference
gathers up to each subsystem's "gather" level and dumps the ring on crash);
stderr emission is gated by the per-subsystem `debug_<subsys>` config
option, runtime-updatable through an observer.
"""
from __future__ import annotations

import sys
import time
import traceback
from collections import deque
from dataclasses import dataclass

from .lockdep import make_lock


@dataclass(frozen=True)
class Entry:
    stamp: float
    subsys: str
    level: int
    message: str

    def format(self) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.stamp))
        frac = int((self.stamp % 1) * 1000)
        return f"{ts}.{frac:03d} {self.level:2d} {self.subsys}: {self.message}"


class Log:
    """Per-process log sink (reference: ceph::logging::Log)."""

    def __init__(self, config=None, ring_size: int = 10000):
        self._config = config
        self._ring: deque[Entry] = deque(maxlen=ring_size)
        self._lock = make_lock("log::ring")
        self._stderr = bool(config and config.get("log_to_stderr"))
        if config is not None:
            names = [
                n for n in config.table.names()
                if n.startswith("debug_")
                or n in ("log_to_stderr", "log_ring_size")
            ]
            config.add_observer(names, self._on_conf_change)

    def _on_conf_change(self, name: str, value) -> None:
        if name == "log_to_stderr":
            self._stderr = bool(value)
        elif name == "log_ring_size":
            with self._lock:
                self._ring = deque(self._ring, maxlen=int(value))

    def level_for(self, subsys: str) -> int:
        if self._config is None:
            return 5
        name = f"debug_{subsys}"
        if name in self._config.table:
            return self._config.get(name)
        return self._config.get("debug_default")

    def dout(self, subsys: str, level: int, message: str) -> None:
        """Submit one entry (reference: the dout(level) << ... macro)."""
        e = Entry(time.time(), subsys, level, message)
        with self._lock:
            self._ring.append(e)
        if self._stderr and level <= self.level_for(subsys):
            print(e.format(), file=sys.stderr)

    def recent(self, n: int | None = None) -> list[Entry]:
        with self._lock:
            entries = list(self._ring)
        return entries if n is None else entries[-n:]

    def dump_recent(self, file=None) -> None:
        """Flush the ring (reference: Log::dump_recent, wired to the crash
        handler so the last N entries survive an abort)."""
        file = file or sys.stderr
        print("--- begin dump of recent log events ---", file=file)
        for e in self.recent():
            print(e.format(), file=file)
        print("--- end dump of recent log events ---", file=file)

    def dump_on_exception(self, exc: BaseException, file=None) -> None:
        file = file or sys.stderr
        traceback.print_exception(exc, file=file)
        self.dump_recent(file=file)
