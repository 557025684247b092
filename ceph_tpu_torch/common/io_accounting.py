"""cephmeter accounting — bounded-cardinality per-(client, pool) I/O
attribution (reference: the mClock client-profile tags in
src/osd/scheduler/mClockScheduler.cc plus the per-client perf queries of
src/mgr/MetricCollector.{h,cc}; arXiv:1709.05365's finding that
PER-TENANT queueing, not compute, dominates online EC at scale).

The op path used to be anonymous: `osd.op`/`op_w_bytes` aggregate every
client into one counter, so neither a QoS controller nor an operator
can see WHO is driving the load.  `IOAccounting` is a per-daemon table
keyed by (client entity, pool id) recording ops, bytes, and the three
latencies that matter for admission control — batcher ``admission``
wait, coalescing ``queue`` wait, and ``e2e`` op latency — as the
log2 histograms.  The (client, pool) labels ARE the future mClock tags:
a controller that reads these series can hand the same keys straight to
the scheduler's QoS classes.

Cardinality is BOUNDED (a scraper must survive a million clients):

- the table holds at most ``top_k`` live (client, pool) entries;
- on overflow the least-recently-used entry OUTSIDE the top half by
  cumulative ops is evicted (heavy hitters survive a scan of one-op
  clients), and its counts FOLD into a single ``_other_`` bucket —
  sums are preserved, only attribution is lost;
- the prometheus exporter applies a second cap at exposition time
  (mgr/prometheus_module._MAX_LABEL_SETS) with the same fold rule.

The table duck-types ``PerfCounters`` (``name``/``dump()``/
``schema()``) so one ``cct.perf.add(acct)`` makes the labeled series
ride the existing perf dump -> MMgrReport -> prometheus pipeline with
zero new wire plumbing (the cephdev precedent).  Rows render as::

    ceph_client_io_ops{ceph_daemon="osd.0",client="client.a",pool="1"} 12
    ceph_client_io_lat_e2e_bucket{...,le="0.000512"} 9
"""
from __future__ import annotations

from collections import OrderedDict

from .lockdep import make_lock
from .perf_counters import HIST_NUM_BUCKETS, _hist_bucket

#: the per-entry latency histograms (subset of tracer.OP_STAGES plus
#: the end-to-end op latency the client actually feels)
ACCT_STAGES = ("admission", "queue", "e2e")

#: ops that count as writes / reads for the bytes split
_WRITE_OPS = frozenset({"write_full", "write", "append", "delete",
                        "setxattr", "omap_set", "omap_rm", "omap_clear"})
_READ_OPS = frozenset({"read", "stat", "getxattrs", "omap_get", "list"})

#: the fold bucket every evicted / over-cap entry collapses into
OTHER_KEY = ("_other_", "_other_")


def _new_hist() -> dict:
    return {"count": 0, "sum": 0.0, "buckets": [0] * (HIST_NUM_BUCKETS + 1)}


def _hist_add(hist: dict, seconds: float) -> None:
    hist["buckets"][_hist_bucket(seconds)] += 1
    hist["count"] += 1
    hist["sum"] += seconds


def _hist_merge(into: dict, frm: dict) -> None:
    into["count"] += frm["count"]
    into["sum"] += frm["sum"]
    for i, c in enumerate(frm["buckets"]):
        into["buckets"][i] += c


class _Entry:
    __slots__ = ("ops", "ops_w", "ops_r", "bytes_w", "bytes_r", "hists")

    def __init__(self):
        self.ops = 0
        self.ops_w = 0
        self.ops_r = 0
        self.bytes_w = 0
        self.bytes_r = 0
        self.hists = {s: _new_hist() for s in ACCT_STAGES}

    def merge(self, other: "_Entry") -> None:
        self.ops += other.ops
        self.ops_w += other.ops_w
        self.ops_r += other.ops_r
        self.bytes_w += other.bytes_w
        self.bytes_r += other.bytes_r
        for s in ACCT_STAGES:
            _hist_merge(self.hists[s], other.hists[s])


class IOAccounting:
    """Bounded per-(client, pool) accounting table (module docstring).

    Duck-types PerfCounters for PerfCountersCollection.add: the dump is
    one ``per_client`` labeled-rows structure (the prometheus module
    renders it) plus plain ``tracked_clients``/``evictions`` scalars.
    """

    def __init__(self, name: str = "client_io", top_k: int = 64):
        self.name = name
        self.top_k = max(1, int(top_k))
        self._lock = make_lock("client_io::table")
        # LRU order: oldest-touched first (move_to_end on every record)
        self._entries: OrderedDict[tuple[str, str], _Entry] = OrderedDict()
        self._other = _Entry()
        self._evictions = 0

    # -- recording ---------------------------------------------------------
    def _entry_locked(self, client: str, pool) -> _Entry:
        key = (str(client), str(pool))
        e = self._entries.get(key)
        if e is None:
            if len(self._entries) >= self.top_k:
                self._evict_locked()
            e = self._entries[key] = _Entry()
        self._entries.move_to_end(key)
        return e

    def _evict_locked(self) -> None:
        """Fold ONE entry into `_other_`: the least-recently-used entry
        outside the top half by cumulative ops — heavy hitters are
        protected from being cycled out by a scan of one-op clients."""
        protect = self.top_k // 2
        if protect:
            # reversed iteration = most-recently-used first, so a tie on
            # ops protects the FRESH entry and lets stale ones cycle out
            by_ops = sorted(reversed(self._entries.items()),
                            key=lambda kv: kv[1].ops, reverse=True)
            protected = {k for k, _ in by_ops[:protect]}
        else:
            protected = set()
        victim = next((k for k in self._entries if k not in protected),
                      next(iter(self._entries)))
        self._other.merge(self._entries.pop(victim))
        self._evictions += 1

    def record_op(self, client: str, pool, op: str, nbytes: int = 0,
                  e2e: float | None = None) -> None:
        """One completed op: classify read/write, count bytes, feed the
        e2e latency histogram."""
        with self._lock:
            e = self._entry_locked(client, pool)
            e.ops += 1
            if op in _WRITE_OPS:
                e.ops_w += 1
                e.bytes_w += int(nbytes)
            elif op in _READ_OPS:
                e.ops_r += 1
                e.bytes_r += int(nbytes)
            if e2e is not None:
                _hist_add(e.hists["e2e"], e2e)

    def record_stage(self, client: str, pool, stage: str,
                     seconds: float) -> None:
        """One admission/queue stage sample (the write batcher calls
        this from the op thread / flusher with the identity the OSD
        stamped into the op-trace state)."""
        if stage not in ACCT_STAGES:
            return
        with self._lock:
            _hist_add(self._entry_locked(client, pool).hists[stage],
                      seconds)

    def reads_of(self, client: str, pool) -> int:
        """Accumulated read-op count for one (client, pool) identity —
        the cephread hot-object cache's promotion signal (an identity
        folded into `_other_` reads 0: an evicted row was, by
        construction, not a heavy hitter).  Does NOT touch LRU order:
        a promotion probe is not traffic."""
        with self._lock:
            e = self._entries.get((str(client), str(pool)))
            return e.ops_r if e is not None else 0

    # -- introspection -----------------------------------------------------
    def totals(self) -> dict:
        """Aggregate across every entry INCLUDING `_other_` — the
        conservation check (evictions lose attribution, never counts)."""
        with self._lock:
            agg = _Entry()
            for e in self._entries.values():
                agg.merge(e)
            agg.merge(self._other)
            return {"ops": agg.ops, "ops_w": agg.ops_w,
                    "ops_r": agg.ops_r, "bytes_w": agg.bytes_w,
                    "bytes_r": agg.bytes_r,
                    "e2e_count": agg.hists["e2e"]["count"]}

    def _row(self, key: tuple[str, str], e: _Entry) -> dict:
        return {
            "labels": {"client": key[0], "pool": key[1]},
            "ops": e.ops, "ops_w": e.ops_w, "ops_r": e.ops_r,
            "bytes_w": e.bytes_w, "bytes_r": e.bytes_r,
            "lat_admission": {"count": e.hists["admission"]["count"],
                              "sum": e.hists["admission"]["sum"],
                              "buckets": list(e.hists["admission"]["buckets"])},
            "lat_queue": {"count": e.hists["queue"]["count"],
                          "sum": e.hists["queue"]["sum"],
                          "buckets": list(e.hists["queue"]["buckets"])},
            "lat_e2e": {"count": e.hists["e2e"]["count"],
                        "sum": e.hists["e2e"]["sum"],
                        "buckets": list(e.hists["e2e"]["buckets"])},
        }

    # -- PerfCounters duck type (rides cct.perf -> MMgrReport) -------------
    def dump(self) -> dict:
        with self._lock:
            rows = [self._row(k, e) for k, e in sorted(
                self._entries.items(),
                key=lambda kv: kv[1].ops, reverse=True)]
            if self._other.ops or self._other.hists["admission"]["count"] \
                    or self._other.hists["queue"]["count"]:
                rows.append(self._row(OTHER_KEY, self._other))
            return {
                "per_client": {"__labeled__": True, "rows": rows},
                "tracked_clients": len(self._entries),
                "evictions": self._evictions,
            }

    def schema(self) -> dict:
        return {
            "per_client": {
                "type": "labeled",
                "description": "per-(client,pool) I/O accounting rows "
                               "(bounded top-K + LRU + _other_ overflow; "
                               "docs/observability.md)"},
            "ops": {"type": "u64",
                    "description": "client ops attributed to this "
                                   "(client,pool)"},
            "ops_w": {"type": "u64", "description": "attributed writes"},
            "ops_r": {"type": "u64", "description": "attributed reads"},
            "bytes_w": {"type": "u64",
                        "description": "attributed bytes written"},
            "bytes_r": {"type": "u64",
                        "description": "attributed bytes read"},
            "lat_admission": {
                "type": "histogram",
                "description": "per-client write-batcher admission wait"},
            "lat_queue": {
                "type": "histogram",
                "description": "per-client coalescing queue wait"},
            "lat_e2e": {
                "type": "histogram",
                "description": "per-client end-to-end op latency at the "
                               "primary"},
            "tracked_clients": {
                "type": "gauge",
                "description": "live (client,pool) accounting entries"},
            "evictions": {
                "type": "u64",
                "description": "entries folded into _other_ by the "
                               "cardinality bound"},
        }
