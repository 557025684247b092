"""Bounded per-PG op log — the data plane's checkpoint/resume mechanism
(reference: src/osd/PGLog.{h,cc} + pg_log_entry_t in osd_types.h;
SURVEY.md §5.4 "an OSD returning after a short outage replays the delta
instead of full copy").

Simplifications vs the reference, by design:
- versions are a single monotonically increasing integer per PG (the
  reference's eversion_t (epoch, version) — epochs matter there because
  primaries diverge; here the primary serializes all writes and peering
  truncates stragglers, so a scalar version is sufficient and the
  divergent-entry rewind machinery collapses into `entries_since`).
- entries record (version, op, oid); op is "modify", "delete", "attr"
  (an xattr-only mutation: recovered exactly like a modify, but it does
  NOT move the object's data-generation floor — chunk bytes are
  untouched, so no chunk stamp will ever carry its version), or "clean"
  (a data-less version marker recovery uses to seal a peer at the
  primary's version) — enough to reconstruct a missing-object set, which
  is all recovery needs.

Persistence: the log rides in the same ObjectStore transaction as the data
write (omap of the PG meta object), exactly how the reference keeps log and
data atomic.
"""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_LOG_LIMIT = 500  # reference: osd_min_pg_log_entries ballpark


@dataclass(frozen=True)
class LogEntry:
    version: int
    op: str  # "modify" | "delete" | "clean"
    oid: str
    # client reqid of the mutation, if any (reference: pg_log_entry_t's
    # reqid / pg_log_dup_t): because it rides IN the replicated+persisted
    # log entry, dup detection survives primary restarts and acting-set
    # changes — a new primary's delta-recovered log still answers resends
    reqid: str | None = None

    def to_list(self) -> list:
        if self.reqid is None:
            return [self.version, self.op, self.oid]
        return [self.version, self.op, self.oid, self.reqid]

    @classmethod
    def from_list(cls, v: list) -> "LogEntry":
        return cls(int(v[0]), str(v[1]), str(v[2]),
                   str(v[3]) if len(v) > 3 else None)


class PGLog:
    """In-memory form; persisted as omap keys by the owning PG."""

    def __init__(self, limit: int = DEFAULT_LOG_LIMIT):
        self.limit = limit
        self.entries: list[LogEntry] = []  # ascending version
        self.head = 0          # newest version (0 = empty PG)
        self.tail = 0          # version BEFORE the oldest retained entry
        # reqid -> version for the retained window (reference:
        # pg_log_dup_t set): dup detection against the replicated log
        self.reqids: dict[str, int] = {}
        # oid -> newest DATA-mutation version ever logged (reference:
        # the missing-set's need versions): the generation FLOOR readers
        # and rebuilders require — serving a chunk generation below it
        # would resurrect pre-write bytes whenever the current copies
        # are temporarily unreachable.  Kept across trims (floors stay
        # true); rebuilt from the retained window after a reload.
        self.obj_newest: dict[str, int] = {}

    def append(self, entry: LogEntry) -> list[LogEntry]:
        """Append and trim; returns entries trimmed off the tail."""
        assert entry.version > self.head, (entry, self.head)
        self.entries.append(entry)
        self.head = entry.version
        if entry.reqid is not None:
            self.reqids[entry.reqid] = entry.version
        if entry.op in ("modify", "delete"):
            # NOT "attr": xattr-only entries leave chunk bytes (and
            # stamps) alone, so they must not raise the data floor
            self.obj_newest[entry.oid] = entry.version
        trimmed: list[LogEntry] = []
        while len(self.entries) > self.limit:
            e = self.entries.pop(0)
            trimmed.append(e)
            self.tail = e.version
            if e.reqid is not None and self.reqids.get(e.reqid) == e.version:
                self.reqids.pop(e.reqid, None)
        return trimmed

    def find_reqid(self, reqid: str) -> int | None:
        """Version at which a client op was applied, if it is in the
        retained log window (None = never seen or trimmed away)."""
        return self.reqids.get(reqid)

    def covers(self, version: int) -> bool:
        """Can a peer at `version` be delta-recovered from this log?"""
        return version >= self.tail

    def reset_to(self, version: int) -> None:
        """Empty the log window at `version` (head = tail = version): the
        state after a full backfill, where nothing below `version` can be
        vouched for entry-by-entry (reference: pg_log rewind/reset on
        backfill completion keeps covers() honest)."""
        self.entries = []
        self.head = self.tail = version
        self.reqids = {}
        # obj_newest survives: the floors reflect real history

    def entries_since(self, version: int) -> list[LogEntry]:
        return [e for e in self.entries if e.version > version]

    def missing_since(self, version: int) -> tuple[dict[str, int], set[str]]:
        """(oid -> newest version to recover, oids deleted) for a peer at
        `version` (reference: pg_missing_t built from log divergence)."""
        newest: dict[str, int] = {}
        deleted: set[str] = set()
        for e in self.entries_since(version):
            if e.op == "clean":
                continue  # version marker, no object behind it
            if e.op == "delete":
                deleted.add(e.oid)
                newest.pop(e.oid, None)
            else:
                deleted.discard(e.oid)
                newest[e.oid] = e.version
        return newest, deleted

    # -- persistence -------------------------------------------------------
    @staticmethod
    def omap_key(version: int) -> str:
        return f"log.{version:016d}"

    @classmethod
    def load(cls, pairs: dict[str, bytes], head: int, tail: int,
             limit: int = DEFAULT_LOG_LIMIT) -> "PGLog":
        import json

        log = cls(limit)
        log.head, log.tail = head, tail
        for k in sorted(pairs):
            if k.startswith("log."):
                e = LogEntry.from_list(json.loads(pairs[k]))
                # stale keys below the window (left behind by a reset_to
                # seal) must not resurrect into the live log
                if tail < e.version <= head:
                    log.entries.append(e)
                    if e.reqid is not None:
                        log.reqids[e.reqid] = e.version
                    if e.op in ("modify", "delete"):
                        log.obj_newest[e.oid] = max(
                            log.obj_newest.get(e.oid, 0), e.version)
        return log
