"""Per-PG state + shared OSD data-plane constants (reference:
src/osd/PG.h pg state, hobject naming, pg_log dup-op coverage).

Split out of osd/daemon.py (round-4 verdict item #6).
"""
from __future__ import annotations


import threading
from collections import OrderedDict

from ..common.lockdep import make_lock
from .pg_log import PGLog

class PGState:
    def __init__(self, pgid: str, pool_id: int, ps: int):
        self.pgid = pgid
        self.pool_id = pool_id
        self.ps = ps
        self.log = PGLog()
        self.version = 0
        # highest pool pg_num this PG has been split-scanned under (0 =
        # scan on next pass; in-memory: a restart just rescans)
        self.split_scanned = 0
        # live-snap-id tuple this PG was last trimmed against (None =
        # never trimmed; distinct from () = trimmed against empty set)
        self.snap_trimmed: tuple | None = None
        # epoch at which this PG's up/acting last CHANGED (reference:
        # pg_history_t::same_interval_since): sub-ops stamped with an
        # older epoch come from a primary of a PAST interval — a stale
        # primary racing a map change — and must be refused, or its
        # writes fork the PG's history behind the current interval's back
        self.interval_start = 0
        # interval this PG last completed its peering round in (phase 0
        # of _recover_pg: query peers, adopt the authoritative log).
        # A primary serves NO client ops until activated for the
        # CURRENT interval (reference: PG activation gates ops) — a
        # revived primary answering from its stale log/version would
        # fork history or falsely ack writes it cannot place.
        self.activated_interval = -1
        # formal history of CLOSED up/acting intervals (reference:
        # PastIntervals) — drives choose_acting's candidate pool, the
        # build_prior activation block, and bounded stray probing
        from .past_intervals import PastIntervals

        self.past_intervals = PastIntervals()
        # stray-location cache (reference: missing_loc): shard -> osd
        # that last answered a stray probe for this PG; lets a repeat
        # degraded read skip the probe wave.  In-memory only — a wrong
        # entry just costs one failed fetch and is dropped.
        self.stray_loc: dict[int, int] = {}
        # cumulative closures recorded this process-lifetime (observability
        # only — prune clears the history, not this)
        self.intervals_closed = 0
        # cephheal pg_stats (observability only): object-copies this
        # PG's LIVE peers were missing at the last recovery pass
        # (down/absent shards are counted live by _mgr_report from its
        # store walk); the push helpers decrement as objects land so a
        # long backfill drains visibly between passes
        self.stat_degraded_peers = 0
        # the port's idle-pass skip (osd/recovery.py, CLEAN_REPOLL_S):
        # what this PG's last clean recovery pass saw, and when
        self.clean_key: tuple | None = None
        self.clean_at = 0.0
        # newest map epoch under which this PG logged a write (persisted
        # with the log): a revived OSD uses it as the starting point to
        # REBUILD interval history from the mon's old maps — intervals
        # that passed while it was down were never seen by _on_map
        # (reference: pg_history_t + build via past OSDMaps)
        self.last_map_epoch = 0
        self.intervals_rebuilt = False
        # shard collections known to hold this PG's meta locally (filled
        # by _load_pg_meta/_log_txn so _save_intervals never rescans the
        # whole store per map change)
        self.meta_cids: set[str] = set()
        # interval for which this primary last broadcast MPGClean
        self.clean_broadcast_interval = -1
        # reqid -> (retval, result) of COMPLETED mutations: a client
        # resend whose reply was lost is answered from here instead of
        # re-executed (reference: pg_log dup entries / osd_reqid_t);
        # success-only so retryable -EAGAIN refusals still re-execute
        self.reqid_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # reqid -> Event of a mutation mid-execution: a resend racing the
        # original waits here instead of double-executing (reference:
        # PrimaryLogPG::check_in_progress_op)
        self.inflight: dict[str, threading.Event] = {}
        self.lock = make_lock("osd::pg")

    def meta_oid(self) -> str:
        return "_pgmeta"


# clone-object name separator (reference: clones are (oid, snapid) hobjects;
# here the snapid rides in the name, invisible to client listings)
CLONE_SEP = "\x02"

# client ops covered by reqid dup detection (mutations whose re-execution
# on a resend would be wrong or wasteful)
MUTATING_OPS = frozenset(
    {"write_full", "write", "append", "delete", "setxattr",
     "omap_set", "omap_rm", "omap_clear", "exec"}
)


def _current_generation(chunks: dict, vers: dict,
                        floor: int | None = None) -> dict:
    """Drop stale-GENERATION chunks: shards versioned below the newest
    version seen carry pre-RMW bytes that must never be mixed into a
    decode (None = wildcard, e.g. backfill-rebuilt).  `floor` is the
    LOG's newest data version for the object (when known): even if every
    reachable chunk is older — the current copies are on a crashed
    disk — the stale generation must read as MISSING, not as current,
    or a later splice-and-rewrite would launder the rollback into a
    fresh higher version (reference: the missing/unfound machinery)."""
    present = [v for v in vers.values() if v is not None]
    if floor is not None:
        present.append(floor)
    if not present:
        return chunks
    target = max(present)
    return {
        s: b for s, b in chunks.items()
        if vers.get(s) is None or vers.get(s) == target
    }


