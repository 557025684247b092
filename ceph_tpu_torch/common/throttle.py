"""Backpressure primitives (reference: src/common/Throttle.{h,cc} ::
Throttle; SURVEY.md §2.7).

Used by the Objecter (in-flight op/byte caps) and the OSD (recovery /
backfill limits).  `get` blocks until the budget fits, FIFO-fair the way the
reference's cond-per-waiter list is; `get_or_fail` never blocks.
"""
from __future__ import annotations

from collections import deque
from threading import Condition

from .lockdep import make_lock


class Throttle:
    def __init__(self, name: str, max_count: int):
        self.name = name
        self._max = max_count
        self._count = 0
        self._lock = make_lock("throttle::budget")
        self._cond = Condition(self._lock)
        self._waitq: deque[object] = deque()  # FIFO ticket queue

    @property
    def max(self) -> int:
        return self._max

    @property
    def current(self) -> int:
        return self._count

    def reset_max(self, max_count: int) -> None:
        with self._cond:
            self._max = max_count
            self._cond.notify_all()

    def _fits(self, c: int) -> bool:
        if self._max <= 0:  # 0 disables throttling, as in the reference
            return True
        return self._count + c <= self._max or self._count == 0

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Block until c units fit, FIFO behind earlier waiters so a large
        request cannot be starved by a stream of small ones; oversized
        requests (> max) are admitted alone rather than deadlocking
        (reference behavior)."""
        assert c >= 0
        ticket = object()
        with self._cond:
            self._waitq.append(ticket)
            try:
                ok = self._cond.wait_for(
                    lambda: self._waitq[0] is ticket and self._fits(c),
                    timeout=timeout,
                )
                if not ok:
                    return False
                self._count += c
                return True
            finally:
                self._waitq.remove(ticket)
                self._cond.notify_all()

    def get_or_fail(self, c: int = 1) -> bool:
        with self._cond:
            if self._waitq or not self._fits(c):
                return False
            self._count += c
            return True

    def put(self, c: int = 1) -> int:
        with self._cond:
            assert self._count >= c, f"throttle {self.name} put {c} > held {self._count}"
            self._count -= c
            self._cond.notify_all()
            return self._count

    def past_midpoint(self) -> bool:
        with self._lock:
            return self._max > 0 and self._count >= self._max / 2
