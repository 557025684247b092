"""HeartbeatMap — internal thread-liveness watchdog (reference:
src/common/HeartbeatMap.{h,cc}; SURVEY.md §5.2).

Worker threads reset their handle's timeout before each unit of work; a
checker (the daemon tick) calls is_healthy().  A thread past its grace makes
the map unhealthy; past its suicide grace the process aborts — the
reference's deadlock→fail-fast policy.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from .lockdep import LockdepLock, make_lock


@dataclass
class Handle:
    name: str
    grace: float
    suicide_grace: float
    timeout: float = 0.0  # absolute deadline; 0 = idle
    suicide_timeout: float = 0.0

    def reset_timeout(self, now: float | None = None) -> None:
        """Arm before a unit of work (reference: HeartbeatMap::reset_timeout)."""
        now = time.monotonic() if now is None else now
        self.timeout = now + self.grace
        self.suicide_timeout = now + self.suicide_grace if self.suicide_grace else 0.0

    def clear_timeout(self) -> None:
        self.timeout = 0.0
        self.suicide_timeout = 0.0


class SuicideTimeout(SystemExit):
    pass


@dataclass
class HeartbeatMap:
    _workers: list[Handle] = field(default_factory=list)
    _lock: LockdepLock = field(
        default_factory=lambda: make_lock("heartbeat::map"))
    # test seam: by default a suicide raises; daemons may install os.abort
    on_suicide: object = None

    def add_worker(self, name: str, grace: float, suicide_grace: float = 0.0) -> Handle:
        h = Handle(name, grace, suicide_grace)
        with self._lock:
            self._workers.append(h)
        return h

    def remove_worker(self, h: Handle) -> None:
        with self._lock:
            self._workers.remove(h)

    def is_healthy(self, now: float | None = None) -> bool:
        """Scan all workers (reference: HeartbeatMap::is_healthy)."""
        now = time.monotonic() if now is None else now
        healthy = True
        with self._lock:
            workers = list(self._workers)
        for h in workers:
            if h.suicide_timeout and now > h.suicide_timeout:
                if callable(self.on_suicide):
                    self.on_suicide(h)  # type: ignore[operator]
                raise SuicideTimeout(
                    f"heartbeat_map worker {h.name!r} (pid {os.getpid()}) "
                    f"had suicide timeout after {h.suicide_grace}s"
                )
            if h.timeout and now > h.timeout:
                healthy = False
        return healthy
