"""PastIntervals — per-PG history of closed up/acting intervals
(reference: src/osd/osd_types.h :: PastIntervals / pg_interval_t,
maintained by PastIntervals::check_new_interval, consumed by
PeeringState::build_prior and choose_acting; round-3 verdict task #7).

Why intervals and not just version numbers: after a sequence of
failovers, the OSD with the HIGHEST pg version is not necessarily
reachable from the current acting set, and the current acting set's
own versions prove nothing about writes that happened in an interval
none of them served.  The interval history answers two questions the
generation floors cannot:

1. *Completeness* — may this primary activate?  Only if, for every past
   interval that could have accepted writes (`maybe_went_rw`), at least
   one member has been queried: an unqueried rw interval may hold the
   authoritative log (build_prior's down-osds-we-would-probe blocking).
2. *Where to look* — which non-acting OSDs are worth probing for stray
   chunks/logs?  Exactly the members of past rw intervals, per shard —
   not the whole OSD map (this bounds _probe_stray's former global
   walk).

Intervals are recorded at map-change time on each OSD hosting the PG,
persisted in the PG meta omap, and pruned when the PG goes fully clean
in the current interval (the reference prunes at last_epoch_clean).
"""
from __future__ import annotations

import json

# history cap: a PG that somehow never goes clean must not grow meta
# without bound; the newest intervals are the ones that matter
MAX_INTERVALS = 64


class PastIntervals:
    def __init__(self):
        # newest-last list of {"first", "last", "up", "acting",
        # "primary", "maybe_went_rw"}
        self.intervals: list[dict] = []

    # -- maintenance -------------------------------------------------------
    def add(self, first: int, last: int, up: list[int], acting: list[int],
            primary: int, maybe_went_rw: bool) -> None:
        """Record a CLOSED interval (reference: check_new_interval)."""
        self.intervals.append({
            "first": int(first), "last": int(last),
            "up": [int(o) for o in up],
            "acting": [int(o) for o in acting],
            "primary": int(primary),
            "maybe_went_rw": bool(maybe_went_rw),
        })
        if len(self.intervals) > MAX_INTERVALS:
            del self.intervals[: len(self.intervals) - MAX_INTERVALS]

    def clear(self) -> None:
        self.intervals = []

    def __len__(self) -> int:
        return len(self.intervals)

    def __bool__(self) -> bool:
        return bool(self.intervals)

    # -- queries -----------------------------------------------------------
    def prior_holders(self, exclude: set[int]) -> dict[int, int]:
        """{osd: shard-it-held} over every past rw interval, newest
        first (so an OSD that held different shards across intervals
        reports its most recent role) — the choose_acting candidate
        pool beyond the current acting set."""
        out: dict[int, int] = {}
        for iv in reversed(self.intervals):
            if not iv["maybe_went_rw"]:
                continue
            for shard, osd in enumerate(iv["acting"]):
                if osd >= 0 and osd not in exclude and osd not in out:
                    out[osd] = shard
        return out

    def query_candidates(self, exclude: set[int], is_up,
                         cap: int = 16) -> dict[int, int]:
        """{osd: shard} to query this peering round, chosen so that EVERY
        past rw interval with an up member contributes at least one
        candidate — a flat newest-N cut could starve an old interval
        forever and wedge the blocked_by gate (review r4).  Newest
        intervals still get priority within the cap."""
        out: dict[int, int] = {}
        for iv in reversed(self.intervals):
            if not iv["maybe_went_rw"]:
                continue
            members = [
                (shard, osd) for shard, osd in enumerate(iv["acting"])
                if osd >= 0 and osd not in exclude and is_up(osd)
            ]
            if any(osd in out for _s, osd in members):
                continue  # interval already covered
            for shard, osd in members:
                if len(out) >= cap:
                    # cap reached: still admit ONE member so this
                    # interval is not starved
                    out.setdefault(osd, shard)
                    break
                out[osd] = shard
        return out

    def holders_of_shard(self, shard: int, exclude: set[int]) -> list[int]:
        """OSDs that held `shard` in any past rw interval, newest first —
        the bounded candidate list for stray-chunk probes."""
        out: list[int] = []
        for iv in reversed(self.intervals):
            if not iv["maybe_went_rw"]:
                continue
            acting = iv["acting"]
            if shard < len(acting):
                osd = acting[shard]
                if osd >= 0 and osd not in exclude and osd not in out:
                    out.append(osd)
        return out

    def blocked_by(self, queried: set[int]) -> list[dict]:
        """Past rw intervals NONE of whose acting members was queried
        this peering round (build_prior's blocking condition): each may
        hold the authoritative log, so activating without hearing from
        any member risks serving a forked or stale history.  Returns the
        offending intervals (empty = safe to activate).  Down members
        block too — that is the point: their unheard history is exactly
        the risk."""
        out = []
        for iv in self.intervals:
            if not iv["maybe_went_rw"]:
                continue
            members = {o for o in iv["acting"] if o >= 0}
            if members and not (members & queried):
                out.append(iv)
        return out

    # -- persistence -------------------------------------------------------
    def to_bytes(self) -> bytes:
        return json.dumps(self.intervals).encode()

    @classmethod
    def from_bytes(cls, raw: bytes | None) -> "PastIntervals":
        pi = cls()
        if raw:
            try:
                ivs = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                ivs = []
            if isinstance(ivs, list):
                pi.intervals = [iv for iv in ivs if isinstance(iv, dict)]
        return pi
