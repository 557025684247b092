"""OSD data-plane wire messages (reference: src/messages/MOSDOp.h,
MOSDOpReply.h, MOSDECSubOpWrite.h/MOSDECSubOpRead.h via src/osd/ECMsgTypes.h,
and the pg_query/pg_log peering messages; SURVEY.md §3.1-3.2).

Bulk payloads (object data, chunk bytes) ride as latin-1-safe base64 inside
the JSON body — the framing/crc below is byte-exact either way, and these
messages are small control frames plus one data segment, matching the
reference's header/front/data split in spirit if not in zero-copy.
"""
from __future__ import annotations

import base64

from ..mon.messages import _JsonMessage
from ..msg.message import register_message


def pack_data(data: bytes | None) -> str | None:
    return None if data is None else base64.b64encode(bytes(data)).decode()


def unpack_data(s: str | None) -> bytes | None:
    return None if s is None else base64.b64decode(s)


@register_message
class MOSDOp(_JsonMessage):
    """Client object op to the PG primary (reference: MOSDOp).

    op: write_full | read | delete | stat | list (pg listing for tools).
    `epoch` is the client's map epoch: a primary on a newer map NACKs with
    -ESTALE so the client refreshes and resends (Objecter resend rule).
    `ps` overrides the oid-hash placement seed — the PG-split migrator
    addresses an object still living in its pre-split PG this way (the
    reference reaches old PGs through pg history / past_intervals).
    `snapid` on reads selects the pool-snapshot view of the object
    (served from the newest clone at-or-after that id, else the head).
    `snap_seq` on writes is the client's snap context: the primary clones
    against max(its map's seq, the client's) so a write never races the
    map push after a mksnap (reference: the SnapContext in every MOSDOp).
    `reqid` is the client-unique id of the LOGICAL op, stable across
    resends (reference: osd_reqid_t): the primary's per-PG dup cache
    answers a resent already-applied mutation from it instead of
    re-executing (reference: pg_log dup detection), which is what makes
    append and partial-stripe RMW retry-safe.
    `trace_id`/`parent_span` carry the cephtrace context minted at
    Objecter.op_submit (head-based sampling; None = unsampled).  The
    names deliberately avoid the framing attrs send_message stamps
    (`seq`/`src` — the CL6 field-shadow trap) so the payload values
    survive the wire; tests/test_analyzer_proto.py audits this.
    """

    MSG_TYPE = 42
    FIELDS = ("tid", "pool", "oid", "op", "data", "epoch", "off", "length",
              "ps", "snapid", "snap_seq", "reqid", "trace_id", "parent_span")


@register_message
class MOSDOpReply(_JsonMessage):
    """reference: MOSDOpReply — retval + (for reads) data + map epoch."""

    MSG_TYPE = 43
    FIELDS = ("tid", "retval", "data", "epoch", "result")


@register_message
class MECSubOpWrite(_JsonMessage):
    """Primary → shard OSD: store one chunk (reference: MOSDECSubOpWrite
    carrying ECSubWrite: tid, shard transactions, log entries).

    `entry` is the pg_log entry [version, op, oid(, reqid)] the shard
    must append atomically with the chunk write (delta-recovery
    bookkeeping; the optional reqid makes dup detection survive primary
    changes).  `osize` carries the OBJECT size of a modify so every
    shard can answer stat/padding-strip.
    `xattrs` carries user-xattr updates {name: b64 | null-to-remove},
    applied in the same transaction (librados xattr replication).

    `mode`/`off` carry the partial-stripe RMW sub-ops (reference:
    src/osd/ECTransaction.cc :: generate_transactions — here expressed
    as parity-delta writes, the optimized-EC formulation):
      mode=None  — full-chunk replace (the classic write_full path)
      mode="range" — splice `data` into the chunk at byte `off`
      mode="delta" — GF(2^8)-XOR `data` onto the chunk at byte `off`
                     (parity shards of an RMW)
    Both RMW modes recompute the chunk's hinfo CRC after applying.
    `over` is the object version the RMW transitions FROM: a shard whose
    stored per-object `ver` xattr differs refuses (it is stale and will
    be rebuilt by recovery), and one already at the target version acks
    as a no-op (idempotent replay) — the object_info_t version guard.

    `omap` carries omap mutations or a recovery snapshot:
      {"set": {key: b64}, "rm": [key...], "clear": bool} applied in the
      same transaction; {"snapshot": {key: b64}} replaces the whole omap
      (recovery push, mirroring the xattr snapshot semantics).

    `rmattrs` lists user-xattr names removed in the same transaction as
    a data write (cache-tier dirty marking: the tier.clean clear must be
    atomic with the mutation it rides — see daemon._cache_tier_op's
    state model; `xattrs` can't carry it on a data push because a
    data+xattrs message means a full recovery snapshot).

    `trace_id`/`parent_span` propagate the primary's cephtrace context
    (parent = the primary's `subop` fan-out span) so the replica's
    commit span joins the client's trace tree across daemons."""

    MSG_TYPE = 108
    FIELDS = ("tid", "pgid", "oid", "shard", "data", "crc", "version",
              "entry", "epoch", "xattrs", "mode", "off", "over", "osize",
              "omap", "rmattrs", "trace_id", "parent_span")


@register_message
class MECSubOpWriteReply(_JsonMessage):
    """`sender`/`qlen`/`degraded` (cephstorm) piggyback the replying
    OSD's load on every ack: its id, its mClock queue depth, and its
    backend-sentinel degraded latch.  The primary's repair planner
    reads them from `_peer_load` to skip expensive helpers
    (`_plan_repair_read`); None = an old peer, cost-unaware planning.
    The names avoid the framing attrs (`seq`/`src` — CL6)."""

    MSG_TYPE = 109
    FIELDS = ("tid", "pgid", "shard", "retval", "sender", "qlen",
              "degraded")


@register_message
class MECSubOpRead(_JsonMessage):
    """Primary → shard OSD: fetch chunk bytes (reference: MOSDECSubOpRead).
    `offsets` carries optional (off, len) sub-chunk ranges (CLAY repair).
    `trace_id`/`parent_span` propagate the cephtrace context for traced
    reads (RMW old-byte fetches, degraded-read gathers).

    `reads` (cephread) generalizes the PR-13 multi-range machinery to
    multiple objects: a list of `[oid, off, ln]` entries (off/ln None =
    whole chunk) served in one round trip — the read batcher's one
    sub-op fan-out per flush.  When `reads` is set, `oid`/`offsets` are
    unused and the reply carries per-entry `results` rows instead."""

    MSG_TYPE = 110
    FIELDS = ("tid", "pgid", "oid", "shard", "offsets", "epoch",
              "trace_id", "parent_span", "reads")


@register_message
class MECSubOpReadReply(_JsonMessage):
    """`size` echoes the shard's stored object-size xattr so a primary
    without its own shard copy can still strip stripe padding; `xattrs`
    echoes the user xattrs for the same degraded-primary case.  `ver`
    echoes the stored per-object version xattr (None = unversioned /
    backfilled-wildcard) so readers can reject stale-generation chunks.

    `results` answers a multi-oid `reads` request: one
    `[retval, data(base64), size, ver]` row per request entry, aligned
    by index (`oid`/`data`/`size`/`ver` are None on a batched reply —
    the rows carry everything).

    `sender`/`qlen`/`degraded` (cephstorm) piggyback the replying OSD's
    load — see MECSubOpWriteReply."""

    MSG_TYPE = 111
    FIELDS = ("tid", "pgid", "oid", "shard", "retval", "data", "size",
              "xattrs", "ver", "results", "sender", "qlen", "degraded")


@register_message
class MPGQuery(_JsonMessage):
    """Primary → peer shard: 'what is your PG state?' (reference: MOSDPGQuery
    driving PeeringState; here the peering-lite version: version + log
    bounds so the primary can pick delta vs backfill)."""

    MSG_TYPE = 112
    FIELDS = ("tid", "pgid", "shard", "epoch")


@register_message
class MPGNotify(_JsonMessage):
    """Peer shard → primary: PG info reply (reference: MOSDPGNotify).
    version: last applied version; log_start: oldest version still in the
    bounded log (0 = log covers from the beginning); last_epoch: newest
    map epoch the peer logged a write under (reference: pg_history_t
    riding pg_info_t in notifies) — a freshly-assigned primary with no
    local history uses the minimum over peers as the starting point to
    rebuild PastIntervals from the mon's map archive."""

    MSG_TYPE = 113
    FIELDS = ("tid", "pgid", "shard", "version", "log_start", "oids",
              "last_epoch")


@register_message
class MPGPull(_JsonMessage):
    """Stale primary → ahead peer: 'push me your log delta' (reference:
    peering's authoritative-log adoption — the revived primary catches
    ITSELF up before judging peers; without this it would mint duplicate
    versions and judge ahead-peers clean).  `have_oids` is the
    requester's local object list so the donor can push deletes for
    objects that no longer exist (a survivors-only backfill would
    resurrect deletions).

    `trace_id`/`parent_span` carry the requester's cephheal recovery
    trace context (parent = its `recovery_pull` span, opened BEFORE the
    send) so the donor's rebuild/push spans join the recovery tree
    across daemons.  Named to dodge the framing attrs send_message
    stamps (`seq`/`src` — the CL6 field-shadow trap), like the PR-9
    client-op fields."""

    MSG_TYPE = 116
    FIELDS = ("tid", "pgid", "shard", "from_version", "epoch", "have_oids",
              "trace_id", "parent_span")


@register_message
class MPGPullReply(_JsonMessage):
    """`trace_id`/`parent_span` echo the request's context (the donor's
    completion joining the same recovery tree) — same field-shadow-safe
    naming as MPGPull."""

    MSG_TYPE = 117
    FIELDS = ("tid", "pgid", "shard", "retval", "trace_id", "parent_span")


@register_message
class MOSDPingMsg(_JsonMessage):
    """OSD↔OSD heartbeat (reference: MOSDPing PING/PING_REPLY)."""

    MSG_TYPE = 70
    FIELDS = ("op", "osd", "epoch")


@register_message
class MScrubShard(_JsonMessage):
    """Primary → shard OSD: report your digests for a PG shard
    (reference: MOSDRepScrub requesting a ScrubMap)."""

    MSG_TYPE = 114
    FIELDS = ("tid", "pgid", "shard", "epoch")


@register_message
class MScrubShardReply(_JsonMessage):
    """Shard ScrubMap: oid -> [computed_crc, stored_crc_or_null, size]
    (reference: ScrubMap::object digests; stored != computed means the
    shard's at-rest data rotted under its own hinfo)."""

    MSG_TYPE = 115
    FIELDS = ("tid", "pgid", "shard", "objects")


@register_message
class MWatchNotify(_JsonMessage):
    """Primary OSD → watcher client: a notify fired on a watched object
    (reference: MWatchNotify carrying notify_id/cookie/payload).  The
    watcher replies with MWatchNotifyAck so the notifier's collect
    phase can complete (reference: notify_ack op)."""

    MSG_TYPE = 118
    FIELDS = ("notify_id", "pool", "oid", "cookie", "data")


@register_message
class MWatchNotifyAck(_JsonMessage):
    MSG_TYPE = 119
    FIELDS = ("notify_id", "pool", "oid", "cookie")


@register_message
class MPGClean(_JsonMessage):
    """Primary → acting replicas: the PG went CLEAN in the current
    interval at `epoch` (reference: last_epoch_clean riding pg_info /
    MOSDPGInfo).  Replicas bump their persisted interval-rebuild floor
    and drop their own past-interval history — intervals older than a
    clean point are settled and must never re-block a future peering
    round (their members may be long gone while every byte lives on in
    the clean acting set)."""

    MSG_TYPE = 121
    FIELDS = ("pgid", "shard", "epoch")
