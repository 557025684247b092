"""PerfCounters — typed runtime metrics (reference:
src/common/perf_counters.{h,cc} :: PerfCounters, PerfCountersBuilder,
PerfCountersCollection; SURVEY.md §5.5).

Counters / gauges / time-averages registered per subsystem on the context,
dumped as nested dicts via the admin socket (`perf dump`) and scraped by the
metrics exporter (ceph_tpu.mgr).  Long-running averages keep (sum, count)
pairs exactly like the reference so consumers can compute rate-correct
averages between two dumps.
"""
from __future__ import annotations

import time
from .lockdep import make_lock

TYPE_U64 = "u64"  # monotonically increasing counter
TYPE_GAUGE = "gauge"  # settable value
TYPE_TIME = "time"  # accumulated seconds
TYPE_LONGRUNAVG = "longrunavg"  # (sum, count)
TYPE_HISTOGRAM = "histogram"  # log2-bucket latency histogram

# log2 bucket boundaries in SECONDS: bucket i counts samples <= 2^i µs
# (1 µs .. ~134 s, then +Inf) — the reference's PerfHistogram uses the
# same power-of-two scale so two dumps subtract bucket-by-bucket
HIST_NUM_BUCKETS = 28
HIST_LE = tuple((1 << i) / 1e6 for i in range(HIST_NUM_BUCKETS))


def _hist_bucket(seconds: float) -> int:
    """Index of the first bucket whose upper bound holds `seconds`;
    HIST_NUM_BUCKETS = overflow (+Inf)."""
    us = seconds * 1e6
    if us <= 1.0:
        return 0
    b = int(us - 1e-9).bit_length()  # 2^(b-1) < us <= 2^b (approx)
    if (1 << b) < us:
        b += 1
    return min(b, HIST_NUM_BUCKETS)


class _Counter:
    __slots__ = ("name", "type", "doc", "value", "sum", "count", "buckets")

    def __init__(self, name: str, ctype: str, doc: str):
        self.name = name
        self.type = ctype
        self.doc = doc
        self.value = 0.0
        self.sum = 0.0
        self.count = 0
        self.buckets = (
            [0] * (HIST_NUM_BUCKETS + 1) if ctype == TYPE_HISTOGRAM else None
        )


class PerfCounters:
    """One subsystem's counter set (reference: PerfCounters)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}
        self._lock = make_lock("perf::counters")

    def _add(self, name: str, ctype: str, doc: str) -> None:
        # locked: the kernel-telemetry registry declares counters lazily
        # at first dispatch, racing dump()/schema() iterations
        with self._lock:
            if name in self._counters:
                raise ValueError(
                    f"duplicate perf counter {self.name}.{name}")
            self._counters[name] = _Counter(name, ctype, doc)

    def inc(self, name: str, amount: float = 1) -> None:
        c = self._counters[name]
        with self._lock:
            c.value += amount

    def dec(self, name: str, amount: float = 1) -> None:
        c = self._counters[name]
        assert c.type == TYPE_GAUGE, f"dec on non-gauge {name}"
        with self._lock:
            c.value -= amount

    def set(self, name: str, value: float) -> None:
        c = self._counters[name]
        with self._lock:
            c.value = value

    def tinc(self, name: str, seconds: float) -> None:
        """Accumulate elapsed time (reference: PerfCounters::tinc)."""
        c = self._counters[name]
        with self._lock:
            if c.type == TYPE_LONGRUNAVG:
                c.sum += seconds
                c.count += 1
            else:
                c.value += seconds

    def avg(self, name: str, value: float) -> None:
        """Feed a long-running average sample."""
        c = self._counters[name]
        with self._lock:
            c.sum += value
            c.count += 1

    def hinc(self, name: str, seconds: float) -> None:
        """Feed one latency sample into a log2-bucket histogram
        (reference: PerfHistogram::inc)."""
        c = self._counters[name]
        assert c.type == TYPE_HISTOGRAM, f"hinc on non-histogram {name}"
        b = _hist_bucket(seconds)
        with self._lock:
            c.buckets[b] += 1
            c.sum += seconds
            c.count += 1

    def get(self, name: str) -> float:
        return self._counters[name].value

    def time_fn(self, name: str):
        """Context manager timing a block into a time/longrunavg counter."""
        return _Timer(self, name)

    def dump(self) -> dict:
        out: dict = {}
        with self._lock:
            for c in self._counters.values():
                if c.type == TYPE_LONGRUNAVG:
                    out[c.name] = {"avgcount": c.count, "sum": c.sum}
                elif c.type == TYPE_HISTOGRAM:
                    out[c.name] = {
                        "count": c.count,
                        "sum": c.sum,
                        "buckets": list(c.buckets),  # per-bucket, not cumulative
                    }
                elif c.type == TYPE_U64:
                    out[c.name] = int(c.value)
                else:
                    out[c.name] = c.value
        return out

    def schema(self) -> dict:
        with self._lock:
            return {
                c.name: {"type": c.type, "description": c.doc}
                for c in self._counters.values()
            }


class _Timer:
    __slots__ = ("_pc", "_name", "_t0")

    def __init__(self, pc: PerfCounters, name: str):
        self._pc = pc
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._pc.tinc(self._name, time.perf_counter() - self._t0)
        return False


class PerfCountersBuilder:
    """Declarative construction (reference: PerfCountersBuilder — the
    add_u64_counter / add_time_avg calls in every daemon's ctor)."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64_counter(self, name: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_U64, doc)
        return self

    def add_u64(self, name: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_GAUGE, doc)
        return self

    def add_time(self, name: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_TIME, doc)
        return self

    def add_time_avg(self, name: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_LONGRUNAVG, doc)
        return self

    def add_time_histogram(self, name: str,
                           doc: str = "") -> "PerfCountersBuilder":
        """Log2-bucket latency histogram (reference: PerfHistogram —
        add_u64_counter_histogram), fed via PerfCounters.hinc."""
        self._pc._add(name, TYPE_HISTOGRAM, doc)
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """All of a process's PerfCounters (reference: PerfCountersCollection on
    CephContext; admin socket `perf dump` renders this)."""

    def __init__(self):
        self._loggers: dict[str, PerfCounters] = {}
        self._lock = make_lock("perf::collection")

    def add(self, pc: PerfCounters) -> PerfCounters:
        with self._lock:
            if pc.name in self._loggers:
                raise ValueError(f"duplicate perf counters {pc.name}")
            self._loggers[pc.name] = pc
        return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def get(self, name: str) -> PerfCounters | None:
        return self._loggers.get(name)

    def dump(self) -> dict:
        with self._lock:
            loggers = list(self._loggers.values())
        return {pc.name: pc.dump() for pc in loggers}

    def schema(self) -> dict:
        with self._lock:
            loggers = list(self._loggers.values())
        return {pc.name: pc.schema() for pc in loggers}
