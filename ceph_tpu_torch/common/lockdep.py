"""lockdep — runtime lock-order cycle detection (reference:
src/common/lockdep.cc + common/mutex_debug.h; SURVEY.md §5.2).

Named locks register acquisition-order edges (held -> acquiring) in one
process-global graph; an acquisition that would close a cycle — the ABBA
pattern that deadlocks two threads — raises immediately on the FIRST
occurrence, deterministically, instead of deadlocking intermittently
under load.  Like the reference, ordering is tracked by lock NAME (class
of lock), not instance, so "osd::pg" vs "osd::pgs" ordering violations
are caught regardless of which PG's lock is involved; recursive
re-acquisition of the same named lock by its holder is allowed (RLock
semantics, matching the daemons' usage).

Disabled (the default) the wrappers add one dict lookup per acquire;
enable via lockdep.enable() or the `lockdep` config option at daemon
construction.
"""
from __future__ import annotations

import threading

_enabled = False
_graph_lock = threading.Lock()
# name -> set of names acquired WHILE name was held (order edges)
_order: dict[str, set[str]] = {}
_held = threading.local()

# cephrace seam (qa/race/runtime.py): when a race session is active its
# runtime is installed here and every LockdepLock acquire/release (and
# the Condition save/restore protocol) reports in.  None (the default)
# costs one global load + is-None test per operation.
_race_hooks = None


def set_race_hooks(hooks) -> None:
    global _race_hooks
    _race_hooks = hooks


class LockOrderViolation(RuntimeError):
    pass


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the recorded order graph (between tests)."""
    with _graph_lock:
        _order.clear()


def enabled() -> bool:
    return _enabled


def _holding() -> list[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _would_cycle(frm: str, to: str) -> bool:
    """Is `to` already ordered before `frm` (path to -> ... -> frm)?"""
    seen = set()
    work = [to]
    while work:
        n = work.pop()
        if n == frm:
            return True
        if n in seen:
            continue
        seen.add(n)
        work.extend(_order.get(n, ()))
    return False


def _on_acquire(name: str) -> None:
    stack = _holding()
    if name in stack:  # recursive re-entry of the same class: allowed
        stack.append(name)
        return
    with _graph_lock:
        for held in set(stack):
            if held == name:
                continue
            if _would_cycle(held, name):
                raise LockOrderViolation(
                    f"lock order violation: acquiring {name!r} while "
                    f"holding {held!r}, but {name!r} -> ... -> {held!r} "
                    f"is already recorded"
                )
            _order.setdefault(held, set()).add(name)
    stack.append(name)


def _on_release(name: str) -> None:
    stack = _holding()
    # release order need not be LIFO; drop the most recent entry
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


class LockdepLock:
    """RLock with lockdep order tracking (reference: ceph::mutex which is
    mutex_debug under lockdep builds)."""

    def __init__(self, name: str):
        self.name = name
        # the one legitimately raw lock in the tree: this IS the
        # primitive make_lock wraps
        self._lock = threading.RLock()  # noqa: CL1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        h = _race_hooks
        if h is not None:
            # may raise DeadlockError on a cycle — but only for an
            # UNBOUNDED acquire; try-locks and timed acquires resolve on
            # their own and must not crash (MonClient.ensure_connection's
            # blocking=False probe exists precisely to never stall)
            h.before_acquire(self, blocking and timeout < 0)
        if _enabled:
            _on_acquire(self.name)
        got = self._lock.acquire(blocking, timeout)
        if not got and _enabled:
            _on_release(self.name)
        if h is not None:
            if got:
                h.after_acquire(self)
            else:
                h.acquire_failed(self)
        return got

    def release(self) -> None:
        h = _race_hooks
        if h is not None:
            h.before_release(self)
        self._lock.release()
        if _enabled:
            _on_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol — threading.Condition(make_lock(...)) must fully
    # release a reentrant lock across wait() and restore its recursion
    # depth after; without these Condition falls back to a non-reentrant
    # try-acquire probe that misreads a held RLock as un-owned.  The
    # lockdep held-stack tracks the same save/restore so order edges are
    # not recorded against a lock the thread no longer holds.
    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        depth = 0
        if _enabled:
            stack = _holding()
            while self.name in stack:
                stack.remove(self.name)
                depth += 1
        h = _race_hooks
        if h is not None:
            h.cond_release_save(self)
        return (state, depth)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._lock._acquire_restore(state)
        if _enabled and depth:
            _holding().extend([self.name] * depth)
        h = _race_hooks
        if h is not None:
            h.cond_acquire_restore(self)


def make_lock(name: str) -> LockdepLock:
    return LockdepLock(name)
