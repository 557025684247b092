"""Control-plane message types (reference: src/messages/MMonElection.h,
MMonPaxos.h, MMonCommand.h, MMonSubscribe.h, MOSDBoot.h, MOSDFailure.h,
MOSDMap.h).  JSON-bodied where the reference uses rich structs — the
framing/crc/session machinery below them is identical either way.
"""
from __future__ import annotations

import json

from ..common.buffer import BufferList, BufferListIterator
from ..msg.message import Message, register_message


class _JsonMessage(Message):
    """Base for messages whose body is one JSON object."""

    FIELDS: tuple[str, ...] = ()

    def __init__(self, **kw):
        super().__init__()
        for f in self.FIELDS:
            setattr(self, f, kw.get(f))

    def encode_payload(self, bl: BufferList) -> None:
        bl.append_str(json.dumps({f: getattr(self, f) for f in self.FIELDS}))

    def decode_payload(self, it: BufferListIterator) -> None:
        d = json.loads(it.get_str())
        for f in self.FIELDS:
            setattr(self, f, d.get(f))

    def __repr__(self):
        body = " ".join(f"{f}={getattr(self, f)!r}" for f in self.FIELDS)
        return f"<{type(self).__name__} {body}>"


@register_message
class MMonElection(_JsonMessage):
    """reference: MMonElection — op in {propose, ack, victory}."""

    MSG_TYPE = 65
    FIELDS = ("op", "epoch", "rank", "quorum", "fsid")


@register_message
class MMonPaxos(_JsonMessage):
    """reference: MMonPaxos — op in {collect, last, begin, accept, commit}.
    `version` is the paxos commit version, `pn` the proposal number,
    `value` a base64/hex-free JSON-encoded KV batch."""

    MSG_TYPE = 66
    FIELDS = ("op", "pn", "version", "last_committed", "value", "uncommitted",
              "nonce", "fsid")


@register_message
class MMonCommand(_JsonMessage):
    """reference: MMonCommand — a `ceph` CLI command as a JSON dict with
    `prefix` plus arguments; tid correlates the ack, and `session` is a
    per-client random id so two processes sharing the default entity name
    cannot collide in the monitor's command dedup cache."""

    MSG_TYPE = 50
    FIELDS = ("tid", "cmd", "session")


@register_message
class MMonCommandAck(_JsonMessage):
    MSG_TYPE = 51
    FIELDS = ("tid", "retval", "result")


@register_message
class MMonSubscribe(_JsonMessage):
    """reference: MMonSubscribe — {'osdmap': start_epoch}; the mon replies
    with every map >= start and keeps pushing new epochs."""

    MSG_TYPE = 15
    FIELDS = ("what",)


@register_message
class MOSDMapMsg(_JsonMessage):
    """reference: MOSDMap — full maps keyed by epoch (the reference sends
    incrementals when it can; full maps are the semantic fallback both
    sides must support, and what we always send)."""

    MSG_TYPE = 41
    FIELDS = ("maps",)  # {epoch(str): osdmap json}


@register_message
class MOSDBoot(_JsonMessage):
    """reference: MOSDBoot — an OSD announcing itself (id + public addr)."""

    MSG_TYPE = 71
    FIELDS = ("osd", "host", "port")


@register_message
class MOSDFailure(_JsonMessage):
    """reference: MOSDFailure — 'I can't reach osd.N' report."""

    MSG_TYPE = 72
    FIELDS = ("target", "failed_for", "reporter")


@register_message
class MOSDAlive(_JsonMessage):
    """reference: MOSDAlive / cancellation of a failure report.  An OSD
    that reported a peer down and then hears its ping reply retracts the
    report so the leader's corroboration count drains instead of riding
    until the target reboots.  `reporter` is pinned from `src` before
    any peon→leader forward, exactly like MOSDFailure."""

    MSG_TYPE = 73
    FIELDS = ("target", "reporter")
