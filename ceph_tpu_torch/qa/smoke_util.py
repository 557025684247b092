"""Shared helpers for the qa smoke scripts: poll a
predicate, scrape the prometheus exporter, read a gauge line, and the
thread-leak bracket for cluster start/stop.  One implementation — the
smokes were each re-forking these verbatim, and a fix to e.g. the
exposition-line parsing must not need four edits."""
from __future__ import annotations

import contextlib
import threading
import time


def wait_for(pred, timeout: float, step: float = 0.2):
    """Poll `pred` until truthy or the deadline passes; one final call
    after the deadline so a slow-but-correct state still counts."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


#: thread-name prefixes a clean teardown may still leave behind for a
#: moment: deliberately-abandoned sentinel probes (a hung backend probe
#: is NOT joinable by design — kernel_telemetry self-terminates it) and
#: per-op fire-and-forget helpers that carry their own deadlines
LEAK_ALLOW = ("backend-probe",)


@contextlib.contextmanager
def assert_no_leaked_threads(grace: float = 10.0,
                             allow: tuple[str, ...] = LEAK_ALLOW):
    """The runtime twin of the thread-lifecycle lints: every thread the body
    starts (cluster bring-up, per-op helpers) must be gone again after
    its teardown, modulo the `allow` prefixes.  Polls up to `grace`
    seconds — join(timeout=...) teardowns finish asynchronously — then
    raises AssertionError naming the zombies."""
    before = set(threading.enumerate())

    def leaked():
        return [t for t in threading.enumerate()
                if t.is_alive() and t not in before
                and not t.name.startswith(allow)]

    yield
    wait_for(lambda: not leaked(), grace)
    left = leaked()
    if left:
        raise AssertionError(
            "leaked threads after teardown: "
            + ", ".join(sorted(t.name for t in left)))


def scrape(url: str) -> str:
    """One prometheus exporter scrape, decoded."""
    import urllib.request

    return urllib.request.urlopen(url, timeout=10).read().decode()


def gauge(body: str, metric: str) -> float | None:
    """First sample of `metric` (bare or labeled) in an exposition
    body, or None when the series is absent."""
    for line in body.splitlines():
        if line.startswith(metric + " ") or line.startswith(metric + "{"):
            return float(line.rsplit(" ", 1)[1])
    return None
