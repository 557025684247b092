"""cephheal accounting — per-(pool, codec) repair-bandwidth attribution
(reference: the recovery counters of src/osd/osd_perf_counters plus the
repair-bandwidth framing of regenerating codes, arXiv:1412.3022: the
cost that distinguishes code families is bytes READ from helpers per
byte repaired, and CLAY's sub-chunk repair exists precisely to cut it).

Before cephheal the repair ratio existed only as an offline bench
number (BENCH extra: CLAY(8,4) at 0.344x naive).  This table makes it a
LIVE cluster metric: every shard rebuild records how many helper shards
were read, how many bytes came off them, and how many bytes were
repaired, keyed by (pool, codec) — so ``ceph_recovery_bytes_read /
ceph_recovery_bytes_repaired`` is scrapeable and alertable per pool,
and the future repair-bandwidth-aware recovery scheduler has its
measured read-cost input (ROADMAP "repair-optimal codes" item).

The table duck-types ``PerfCounters`` (``name``/``dump()``/
``schema()``) so one ``cct.perf.add`` makes the labeled rows ride the
existing perf dump -> MMgrReport -> prometheus pipeline with zero new
wire plumbing (the cephmeter/cephdev precedent)::

    ceph_recovery_bytes_read{ceph_daemon="osd.0",pool="1",codec="torch-cauchy_good"} 81920
    ceph_recovery_bytes_repaired{...} 20480

Cardinality is naturally bounded by pool count; a defensive cap folds
overflow into a ``_other_`` row (sums preserved, attribution lost).
"""
from __future__ import annotations

from .lockdep import make_lock

#: defensive row bound (pools are few; a runaway pool-create loop must
#: still not grow the report unboundedly)
_MAX_ROWS = 64

#: the fold row overflow collapses into
OTHER_KEY = ("_other_", "_other_")


class _Row:
    __slots__ = ("repairs", "helper_reads", "bytes_read", "bytes_repaired",
                 "full_gathers")

    def __init__(self):
        self.repairs = 0         # shard rebuilds completed
        self.helper_reads = 0    # helper-shard reads feeding them
        self.bytes_read = 0      # bytes fetched from helpers
        self.bytes_repaired = 0  # bytes of rebuilt shard data
        self.full_gathers = 0    # rebuilds that fell back to the full
        #                          (non-plan) gather path

    def merge(self, other: "_Row") -> None:
        self.repairs += other.repairs
        self.helper_reads += other.helper_reads
        self.bytes_read += other.bytes_read
        self.bytes_repaired += other.bytes_repaired
        self.full_gathers += other.full_gathers


class RecoveryAccounting:
    """Bounded per-(pool, codec) repair-bandwidth table (module
    docstring).  One instance per OSD, added to ``cct.perf``."""

    def __init__(self, name: str = "recovery"):
        self.name = name
        self._lock = make_lock("recovery_acct::table")
        self._rows: dict[tuple[str, str], _Row] = {}
        self._other = _Row()

    def _row_locked(self, pool, codec: str) -> _Row:
        key = (str(pool), str(codec))
        row = self._rows.get(key)
        if row is None:
            if len(self._rows) >= _MAX_ROWS:
                return self._other
            row = self._rows[key] = _Row()
        return row

    def record_repair(self, pool, codec: str, helper_reads: int,
                      bytes_read: int, bytes_repaired: int,
                      full_gather: bool = False) -> None:
        """One completed shard rebuild: `helper_reads` helper shards
        were consulted, `bytes_read` bytes fetched off them, and the
        rebuilt shard is `bytes_repaired` bytes.  `full_gather` marks a
        rebuild that could not follow the codec's minimum_to_decode
        plan (stale generations, unreachable helpers) and read broadly
        instead — those rebuilds inflate the live ratio and the flag
        says why."""
        with self._lock:
            row = self._row_locked(pool, codec)
            row.repairs += 1
            row.helper_reads += int(helper_reads)
            row.bytes_read += int(bytes_read)
            row.bytes_repaired += int(bytes_repaired)
            if full_gather:
                row.full_gathers += 1

    def totals(self) -> dict:
        with self._lock:
            agg = _Row()
            for row in self._rows.values():
                agg.merge(row)
            agg.merge(self._other)
            return {"repairs": agg.repairs,
                    "helper_reads": agg.helper_reads,
                    "bytes_read": agg.bytes_read,
                    "bytes_repaired": agg.bytes_repaired,
                    "full_gathers": agg.full_gathers}

    def ratio(self, pool, codec: str) -> float | None:
        """Live bytes_read / bytes_repaired for one (pool, codec) —
        ~k for an MDS code reading k full chunks per repaired chunk,
        sub-k for a regenerating code (the CLAY point)."""
        with self._lock:
            row = self._rows.get((str(pool), str(codec)))
            if row is None or row.bytes_repaired <= 0:
                return None
            return row.bytes_read / row.bytes_repaired

    @staticmethod
    def _row_dict(key: tuple[str, str], row: _Row) -> dict:
        return {
            "labels": {"pool": key[0], "codec": key[1]},
            "repairs": row.repairs,
            "helper_reads": row.helper_reads,
            "bytes_read": row.bytes_read,
            "bytes_repaired": row.bytes_repaired,
            "full_gathers": row.full_gathers,
        }

    # -- PerfCounters duck type (rides cct.perf -> MMgrReport) -------------
    def dump(self) -> dict:
        with self._lock:
            rows = [self._row_dict(k, r) for k, r in sorted(
                self._rows.items())]
            if self._other.repairs:
                rows.append(self._row_dict(OTHER_KEY, self._other))
            return {
                "per_pool": {"__labeled__": True, "rows": rows},
                "tracked_pools": len(self._rows),
            }

    def schema(self) -> dict:
        return {
            "per_pool": {
                "type": "labeled",
                "description": "per-(pool,codec) repair-bandwidth rows "
                               "(cephheal; docs/observability.md)"},
            "repairs": {
                "type": "u64",
                "description": "shard rebuilds completed for this "
                               "(pool,codec)"},
            "helper_reads": {
                "type": "u64",
                "description": "helper-shard reads feeding rebuilds "
                               "(k per repair for an MDS code on the "
                               "plan path; d for CLAY sub-chunk repair)"},
            "bytes_read": {
                "type": "u64",
                "description": "bytes fetched from helper shards for "
                               "rebuilds — the repair bandwidth "
                               "regenerating codes minimize"},
            "bytes_repaired": {
                "type": "u64",
                "description": "bytes of shard data rebuilt; "
                               "bytes_read/bytes_repaired is the live "
                               "repair ratio (~k for RS, sub-k for "
                               "CLAY)"},
            "full_gathers": {
                "type": "u64",
                "description": "rebuilds that abandoned the "
                               "minimum_to_decode plan and gathered "
                               "broadly (stale generations or "
                               "unreachable helpers)"},
        }
