"""cephread hot-object read cache (reference: the OSD's object context
cache / BlueStore's 2Q onode cache, radically simplified).

A byte-bounded LRU of fully-materialized objects on the PRIMARY,
serving repeat GETs without a chunk gather or decode.  Entries are
keyed by (pgid, oid) and stamped with the object version that produced
them; two mechanisms keep a hit honest:

- **Write-path invalidation**: every mutation that bumps the object
  version (client write, RMW, delete — and, belt-and-braces, a replica
  sub-write apply in case this daemon regains primariness later) calls
  `invalidate()`.
- **Version validation on read**: a hit is served only when the cached
  version equals the PG log's newest version for the oid
  (`pg.log.obj_newest`) — so even a missed invalidation (primary
  flapped away and back while another OSD wrote) degrades to a miss,
  never a stale read.  No log row for the oid → miss.

Promotion is demand-driven by cephmeter: `_ec_read` consults the
per-(client,pool) accounting table and only inserts when the reading
identity has accumulated `osd_read_cache_promote_ops` read ops — a
heavy hitter's working set sticks, a cold one-pass scan never churns
the cache (the classic scan-resistance argument, minus the second
queue).  Only HEALTHY full-object reads fill: a ranged degraded decode
produces a byte window, not an object, and caching reconstructed data
would hide the degradation from scrub.
"""
from __future__ import annotations

from collections import OrderedDict

from ..common.lockdep import make_lock


class ReadCache:
    """Bounded LRU of (pgid, oid) -> (version, object bytes)."""

    def __init__(self, max_bytes: int = 0, logger=None):
        self._logger = logger
        self._lock = make_lock("osd::read_cache")
        self._max_bytes = int(max_bytes)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._inserts = 0
        self._evictions = 0
        self._invalidations = 0

    # -- config ------------------------------------------------------------
    def set_max_bytes(self, max_bytes: int) -> None:
        with self._lock:
            self._max_bytes = int(max_bytes)
            ev = self._evict_locked()
        self._count("read_cache_evictions", ev)

    def enabled(self) -> bool:
        return self._max_bytes > 0

    # -- data path ---------------------------------------------------------
    def get(self, key, newest_ver):
        """Return (data, size) for `key` iff the cached version matches
        the PG log's newest version for the oid; anything else — absent,
        unvalidatable (no log row), or stale — is a miss (a stale entry
        is dropped on the spot)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses += 1
                return None
            ver, data, size = ent
            if newest_ver is None or ver != newest_ver:
                self._entries.pop(key, None)
                self._bytes -= len(data)
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return data, size

    def put(self, key, ver, data: bytes, size: int) -> None:
        if ver is None:
            return
        with self._lock:
            if self._max_bytes <= 0 or len(data) > self._max_bytes:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])
            self._entries[key] = (ver, data, size)
            self._bytes += len(data)
            self._inserts += 1
            ev = self._evict_locked()
        self._count("read_cache_evictions", ev)

    def invalidate(self, key) -> None:
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= len(ent[1])
                self._invalidations += 1
        if ent is not None:
            self._count("read_cache_invalidations", 1)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- internals ---------------------------------------------------------
    def _evict_locked(self) -> int:
        ev = 0
        while self._bytes > self._max_bytes and self._entries:
            _, (_, data, _) = self._entries.popitem(last=False)
            self._bytes -= len(data)
            self._evictions += 1
            ev += 1
        return ev

    def _count(self, name: str, n: int) -> None:
        if n and self._logger is not None:
            self._logger.inc(name, n)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self._max_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
            }
